"""The dataset CLIs' arguments: the flags of the repo's root `utils.py`
`parse_args`, with its `--ascale` presets, its choice of config values
(`--ls`: cfgs/res101_ls.yml's, whatever the backbone; else cfgs/res50.yml's)
and dataset-name mapping, plus `--device`.

Flags and settings that ask for what the port does not have yet are
refused with the ROADMAP item that ports it, instead of being ignored.
The parallel flags (--mGPUs, --tp, --sp, --slices, --dist with
--coordinator, --num_procs, --proc_id) mean what they mean in the JAX
CLIs; each CLI reads them (dana_tpu_torch/parallel).
"""

from __future__ import annotations

import argparse
import os

from dana_tpu_torch.models.dana import POOLING_MODES
from dana_tpu_torch.quant import SCOPES as QUANT_SCOPES
from dana_tpu_torch.utils import config as config_lib

# the --ascale presets (reference utils.py:68-73)
ASCALE_PRESETS = {
    3: ['ANCHOR_SCALES', '[8, 16, 32]', 'ANCHOR_RATIOS', '[0.5,1,2]',
        'MAX_NUM_GT_BOXES', '30'],
    4: ['ANCHOR_SCALES', '[4, 8, 16, 32]', 'ANCHOR_RATIOS', '[0.5,1,2]',
        'MAX_NUM_GT_BOXES', '50'],
}

# dataset name -> (train imdb, eval imdb) (reference utils.py:74-104)
DATASETS = {
    'pascal_voc': ('voc_2007_trainval', 'voc_2007_test'),
    'coco': ('coco_2014_train', 'coco_2014_minival'),
    'coco_base': ('coco_60_set1', None),
    'coco_ft': ('coco_ft_shot30', None),
    'val2014_novel': (None, 'coco_20_set1'),
    'val2014_base': (None, 'coco_20_set2'),
    'synth': ('synth_train', 'synth_test'),
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='DAnA few-shot detection on '
                                'the PyTorch port')
    a = p.add_argument
    a('--dataset', default='pascal_voc', type=str)
    a('--net', default='DAnA', type=str,
      help='DAnA, cisa (DAnA without the BA block), frcnn, fsod, meta, fgn, '
           'or a backbone name res50, res101, vgg16 (DAnA on that trunk)')
    a('--backbone', default='res50', type=str,
      help='res50, res101 or vgg16 (the siblings: the ResNets only)')
    a('--flip', dest='use_flip', action='store_true', default=False)
    a('--o', dest='optimizer', default='sgd', type=str)
    a('--lr', default=0.001, type=float)
    a('--lr_decay_step', default=1000, type=int)
    a('--lr_decay_gamma', default=0.1, type=float)
    a('--nw', dest='num_workers', default=8, type=int)
    a('--ls', dest='large_scale', action='store_true',
      help="cfgs/res101_ls.yml's values: 800 px queries, 1000 proposals")
    a('--mGPUs', dest='mGPUs', action='store_true')
    a('--tp', dest='tp', default=0, type=int)
    a('--sp', dest='sp', default=0, type=int)
    a('--slices', dest='slices', default=0, type=int)
    a('--bs', dest='batch_size', default=16, type=int)
    a('--start_epoch', default=1, type=int)
    a('--epochs', dest='max_epochs', default=12, type=int)
    a('--disp_interval', default=100, type=int)
    a('--save_dir', default='models', type=str)
    a('--ascale', default=4, type=int)
    a('--eval', dest='eval', action='store_true', default=False)
    a('--onc', dest='old_n_classes', default=81, type=int)
    a('--eval_dir', default=None, type=str)
    a('--fs', dest='fewshot', action='store_true', default=False)
    a('--way', default=1, type=int)
    a('--shot', default=5, type=int)
    a('--sup_dir', default='all', type=str)
    a('--r', dest='resume', action='store_true', default=False)
    a('--load_dir', default='models', type=str)
    a('--checkepoch', default=1, type=int)
    a('--checkpoint', default=0, type=int)
    a('--checkpath', default=None, type=str,
      help='explicit checkpoint path (.dkpt or .pth)')
    a('--dlog', action='store_true', default=False)
    a('--imlog', action='store_true', default=False)
    a('--seed', default=1996, type=int)
    a('--clip_norm', default=0.0, type=float)
    a('--steps_per_call', default=1, type=int)
    a('--ckpt_backend', default='pickle', type=str,
      choices=['pickle', 'orbax'])
    a('--profile', default=None, type=str)
    a('--dist', action='store_true', default=False)
    a('--coordinator', default=None, type=str)
    a('--num_procs', default=None, type=int)
    a('--proc_id', default=None, type=int)
    a('--device', default='cuda', type=str,
      help="'cuda' (the default: the card) or 'cpu' (the kernels' plain "
           'versions)')
    a('--set', dest='set_cfgs_extra', nargs='*', default=None,
      help='extra config overrides: KEY VALUE ...')
    args = p.parse_args(argv)

    if args.ascale not in ASCALE_PRESETS:
        raise SystemExit(f'invalid anchor scale {args.ascale}')
    args.set_cfgs = list(ASCALE_PRESETS[args.ascale])
    if args.dataset in DATASETS:
        train_name, val_name = DATASETS[args.dataset]
        if train_name:
            args.imdb_name = train_name
        if val_name:
            args.imdbval_name = val_name
    elif args.dataset.startswith(('coco_', 'synth_', 'ycb2d_', 'voc_')):
        args.imdb_name = args.imdbval_name = args.dataset
    else:
        raise SystemExit(f'dataset {args.dataset} not defined')
    _refuse_unported(args)
    return args


def _check_dist(args):
    """--dist joins a group of --num_procs processes as --proc_id (or
    torchrun's WORLD_SIZE and RANK) through --coordinator."""
    if not args.dist:
        return
    if args.num_procs is None and 'WORLD_SIZE' not in os.environ:
        raise SystemExit('--dist needs --num_procs (or torchrun\'s '
                         'WORLD_SIZE)')
    if args.proc_id is None and 'RANK' not in os.environ:
        raise SystemExit('--dist needs --proc_id (or torchrun\'s RANK)')
    if args.num_procs is not None and args.proc_id is not None \
            and not 0 <= args.proc_id < args.num_procs:
        raise SystemExit(f'--proc_id {args.proc_id} is not below --num_procs '
                         f'{args.num_procs}')


def _refuse_unported(args):
    _check_dist(args)
    if args.net not in config_lib.NETS:
        raise SystemExit(f'--net {args.net}: the port has '
                         f'{", ".join(config_lib.NETS)}')
    if args.backbone not in config_lib.BACKBONES:
        raise SystemExit(f'--backbone {args.backbone}: the trunks are '
                         f'{", ".join(config_lib.BACKBONES)}')
    framework = config_lib.NETS[args.net]
    if args.backbone == 'vgg16' and framework not in ('DAnA', 'cisa'):
        raise SystemExit(f'--net {args.net} --backbone vgg16: the siblings '
                         'are ResNet-only, as in the JAX package, whose '
                         'sibling inits raise KeyError for vgg16')
    if args.ckpt_backend != 'pickle':
        raise SystemExit('--ckpt_backend orbax: the port reads and writes '
                         'the .dkpt pickle only')


def load_cfg(args):
    """-> the config tree: the built-in res50 values (with --ls, those of
    res101_ls.yml), then the --ascale preset, then --set.  Refuses settings
    the port has no code for."""
    c = config_lib.default_cfg()
    if args.large_scale:
        config_lib.cfg_from_list(c, config_lib.LARGE_SCALE)
    config_lib.cfg_from_list(c, args.set_cfgs)
    if args.set_cfgs_extra:
        config_lib.cfg_from_list(c, args.set_cfgs_extra)
    c.TRAIN.USE_FLIPPED = args.use_flip
    if c.TPU.QUANT_SCOPE not in QUANT_SCOPES:
        raise SystemExit(f'TPU.QUANT_SCOPE {c.TPU.QUANT_SCOPE}: the scopes '
                         f'are {", ".join(QUANT_SCOPES)}')
    if c.POOLING_MODE not in POOLING_MODES:
        raise SystemExit(f'POOLING_MODE {c.POOLING_MODE}: the modes are '
                         f'{", ".join(POOLING_MODES)}')
    try:
        for k in ('COMPUTE_DTYPE', 'ATTENTION_DTYPE', 'HEAD_DTYPE'):
            config_lib.dtype_or_none(c.TPU[k])
    except ValueError as e:
        raise SystemExit(str(e)) from None
    return c
