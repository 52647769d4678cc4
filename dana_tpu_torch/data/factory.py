"""Dataset registry: name -> constructor, ported from the JAX package's
`data/factory.py` for its COCO-format datasets.

Registered: the `synth_*` sets, the reference's COCO FSOD splits, the
pre-generated episodes, COCO 2014, `coco_80_ft` and the ycb2d sets.
Datasets are built lazily under the config's DATA_DIR; a missing
annotation file raises when its dataset is built.  Pascal VOC, Visual
Genome and ImageNet are not ported yet (ROADMAP Queue A 7): their names
raise KeyError saying so.
"""

from __future__ import annotations

import os.path as osp

from dana_tpu_torch.data.coco_split import (CocoFormatDataset,
                                            _coco_image_name, coco_split)
from dana_tpu_torch.data.synth import synth_fsod

_SETS = {}
_UNPORTED = ('voc_', 'vg_', 'imagenet_')


def _register(name, fn):
    """fn(data_dir) -> dataset."""
    _SETS[name] = fn


def _register_synth():
    _register('synth_train', lambda d: synth_fsod('train'))
    _register('synth_test', lambda d: synth_fsod('test', num_images=20))
    _register('synth_train_big', lambda d: synth_fsod('train_big',
                                                      num_images=240))
    _register('synth_test_big', lambda d: synth_fsod('test_big',
                                                     num_images=60))
    # end-to-end CLI throughput runs: large enough that the steady state
    # outweighs set-up
    _register('synth_test_400', lambda d: synth_fsod('test_400',
                                                     num_images=400))
    # the 400-image eval's support split (the CLI derives it by a
    # test -> train name substitution)
    _register('synth_train_400', lambda d: synth_fsod('train_big',
                                                      num_images=240))


def _register_coco():
    # the reference's FSOD splits (factory.py:46-70)
    for year in ['set1', 'set2', 'set3', 'set4', 'set1allcat']:
        _register(f'coco_60_{year}',
                  lambda d, y=year: coco_split('60', y, d))
    for year in ['set1', 'set2', 'set3', 'set4']:
        _register(f'coco_20_{year}',
                  lambda d, y=year: coco_split('20', y, d))
        _register(f'coco_vis_{year}',
                  lambda d, y=year: coco_split('vis', y, d))
    for split in ['3way', '5way']:
        for year in ['set1', 'set2']:
            _register(f'coco_{split}_{year}',
                      lambda d, s=split, y=year: coco_split(s, y, d))
    _register('coco_ft', lambda d: coco_split('shot', '10', d))
    for tag in ['3way1', '3way2']:
        _register(f'coco_20_{tag}', lambda d, t=tag: coco_split('3way', t, d))
    for tag in ['5way1', '5way2']:
        _register(f'coco_20_{tag}', lambda d, t=tag: coco_split('5way', t, d))
    _register('coco_ft_shot30', lambda d: coco_split('shot', 'shot30', d))

    # pre-generated episodes (factory.py:73-77)
    def episode_ds(data_dir, kind, n):
        d = osp.join(data_dir, 'coco')
        sub = {'novel': ('coco_epi', f'novel_ep{n}.json', 'val2014'),
               'base': ('coco_epi', f'base_ep{n}.json', 'val2014'),
               'val': ('coco_val', f'val_ep{n}.json', 'val2014')}[kind]
        return CocoFormatDataset(
            f'coco_{kind}_ep{n}', osp.join(d, 'annotations', sub[0], sub[1]),
            osp.join(d, 'images', sub[2]), _coco_image_name(sub[2]))
    for n in range(600):
        for kind in ('novel', 'base', 'val'):
            _register(f'coco_{kind}_ep{n}',
                      lambda d, k=kind, i=n: episode_ds(d, k, i))

    # COCO 2014 (factory.py:47-55)
    def coco2014(data_dir, split):
        d = osp.join(data_dir, 'coco')
        return CocoFormatDataset(
            f'coco_2014_{split}',
            osp.join(d, 'annotations', f'instances_{split}2014.json'),
            osp.join(d, 'images', f'{split}2014'),
            _coco_image_name(f'{split}2014'))
    for split in ['train', 'val', 'minival', 'valminusminival', 'trainval']:
        _register(f'coco_2014_{split}', lambda d, s=split: coco2014(d, s))

    # coco80 finetune (coco_finetune.py:63-66)
    def coco_ft(data_dir):
        d = osp.join(data_dir, 'coco')
        return CocoFormatDataset(
            'coco_80_ft', osp.join(d, 'annotations', 'coco80_finetune',
                                   'instances_shot.json'),
            osp.join(d, 'images', 'train2014'),
            _coco_image_name('train2014'))
    _register('coco_80_ft', coco_ft)


def _register_ycb2d():
    # the reference's ycb2d names (factory.py:14-44), COCO-format anns
    def ycb2d(data_dir, split):
        d = osp.join(data_dir, 'ycb2d')
        return CocoFormatDataset(f'ycb2d_{split}',
                                 osp.join(d, 'annotations', f'{split}.json'),
                                 osp.join(d, 'images'))
    tags = [f'replace{i}' for i in [256, 240, 224, 208, 200, 192, 160, 128,
                                    100, 96, 80, 64, 50, 48, 32, 30, 20, 16,
                                    10]]
    tags += ['inference_sparse', 'inferencefs_sparse', 'inference_dense',
             'inferencefs_dense', 'inference']
    tags += [f'stage{i}' for i in [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14,
                                   16, '1cls', '2cls', '3cls', '4cls']]
    tags += [f'oracle{i}' for i in [512, 256, 128, 64, 32, 16, 8]]
    tags += [f'oracle_dense{i}' for i in [64, 32, 16]]
    tags += [f'fsoracle_dense{i}' for i in [20, 10, 5]]
    tags += [f'pseudo{i}' for i in range(1, 10)]
    tags += ['train', 'val', 'test', 'debug', 'strict', 'normal', 'hard',
             'ycbv_train', 'ycbv_debug']
    for split in tags:
        _register(f'ycb2d_{split}', lambda d, s=split: ycb2d(d, s))


_register_synth()
_register_coco()
_register_ycb2d()


def get_imdb(name: str, data_dir: str = 'data'):
    """Build the dataset registered under `name` (factory.py
    get_imdb:93-97); `data_dir` is the config's DATA_DIR."""
    if name.startswith(_UNPORTED):
        raise KeyError(f'{name}: Pascal VOC, Visual Genome and ImageNet are '
                       'not ported yet (ROADMAP Queue A 7)')
    if name not in _SETS:
        raise KeyError(f'Unknown dataset: {name}')
    return _SETS[name](data_dir)
