"""N-way episodic evaluation on the PyTorch port: the protocol of the
repo's `tools/synth_multiway_eval.py` (the reference's MultiwayLoader; the
paper's 5-way K-shot shape, BASELINE config #4).

    python -m dana_tpu_torch.multiway_eval <ckpt.dkpt|.pth> [way] [shot] \\
        [arch] [--device cpu]

way 5, shot 2 and arch resnet50 by default.  The tool's settings: 304 px
queries on the (304, 512), (512, 304) and (416, 416) canvases, 600
proposals before NMS and 64 after, 12 anchors.  A fixed support pool
drawn from synth_train (`SupportPool(..., seed=0)`); for every synth_test
image the `MultiwayLoader` picks `way` classes (those present first) and
each way's detections, at most 100 // way, are labelled with its class;
the numpy COCOeval scores them jointly.

The detector is the one the checkpoint holds: DAnA with its BA block when
the checkpoint has one (`rpn_channel_k_layer`), else cisa.  The tool
builds its config with the JAX DanaConfig's default, no BA block, which
on a checkpoint that holds one skips it.  Each class's supports are
encoded once; one request an image carries its ways as a batch (the query
repeated, one way a row), which gives the detections of one request a
way.  It runs on the card; without CUDA it raises unless --device cpu is
given.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import numpy as np

from dana_tpu_torch.data.imdb import combined_roidb
from dana_tpu_torch.data.inference_loader import MultiwayLoader, SupportPool
from dana_tpu_torch.engine.predict import Predictor
from dana_tpu_torch.models.dana import CACHED_SUPPORTS, DanaConfig
from dana_tpu_torch.utils import checkpoint as ckpt_lib
from dana_tpu_torch.utils import config as config_lib
from dana_tpu_torch.utils.device import resolve_device

# the tool's cfg_from_list
SETTINGS = ['TEST.RPN_PRE_NMS_TOP_N', '600', 'TEST.RPN_POST_NMS_TOP_N', '64',
            'TPU.NMS_MAX_INPUT', '600', 'TEST.SCALES', '(304,)',
            'TEST.MAX_SIZE', '512',
            'TPU.SIZE_BUCKETS', '[(304, 512), (512, 304), (416, 416)]']
ANCHOR_SCALES = (4, 8, 16, 32)


def load_detector(path, way, shot, arch, c):
    """The checkpoint's DAnA or cisa detector at the tree `c`'s proposal
    counts -> (module on the CPU, config)."""
    payload = ckpt_lib.read_checkpoint(path)
    ba_block = any(k.startswith('rpn_channel_k_layer')
                   for k in payload['model'])
    framework = (payload.get('extra') or {}).get('framework') \
        or ('DAnA' if ba_block else 'cisa')
    if framework not in CACHED_SUPPORTS:
        raise SystemExit(f'{path}: a {framework} checkpoint; the N-way '
                         'protocol serves DAnA and cisa')
    config = DanaConfig(
        n_way=way, n_shot=shot, arch=arch, framework=framework,
        semantic_enhance=ba_block, anchor_scales=ANCHOR_SCALES,
        test_pre_nms=c.TEST.RPN_PRE_NMS_TOP_N,
        test_post_nms=c.TEST.RPN_POST_NMS_TOP_N, nms_cap=c.TPU.NMS_MAX_INPUT)
    model, _ = ckpt_lib.load_checkpoint(path, config, payload)
    return model, config


def evaluate(pred, imdb_te, roidb_te, pool, way, c, out_dir):
    """Every image of roidb_te against `way` classes, one request an image;
    -> the COCOeval result with 'timing' (images, seconds, img/s)."""
    loader = MultiwayLoader(
        roidb_te, pool, num_way=way, pixel_means=c.PIXEL_MEANS,
        max_num_box=c.MAX_NUM_GT_BOXES, buckets=c.TPU.SIZE_BUCKETS,
        scale=c.TEST.SCALES[0],
        max_size=None if c.TPU.EXACT_QUERY_SCALE else c.TEST.MAX_SIZE)
    all_boxes = [[[] for _ in roidb_te] for _ in range(imdb_te.num_classes)]
    t0 = time.perf_counter()
    for cls in pool.classes_available():
        pred.encode_supports(cls, pool.get(cls))
    for i in range(len(roidb_te)):
        item = loader[i]
        ways = [int(w) for w in item['selected_ways']]
        n = len(ways)
        dets, valid = pred.predict(np.repeat(item['im_data'][None], n, 0),
                                   np.repeat(item['im_info'][None], n, 0),
                                   ways)
        dets, valid = dets.cpu().numpy(), valid.cpu().numpy()
        for wi, cls in enumerate(ways):
            all_boxes[cls][i] = dets[wi][valid[wi]]
    secs = time.perf_counter() - t0
    print(f'{len(roidb_te)} images x {way} ways in {secs:.1f}s '
          f'({len(roidb_te) / secs:.2f} img/s)', flush=True)
    result = imdb_te.evaluate_detections(all_boxes, out_dir)
    result['timing'] = dict(images=len(roidb_te), seconds=secs,
                            img_per_s=len(roidb_te) / secs)
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('checkpoint')
    p.add_argument('way', nargs='?', type=int, default=5)
    p.add_argument('shot', nargs='?', type=int, default=2)
    p.add_argument('arch', nargs='?', default='resnet50')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (the default: the card) or 'cpu' (the "
                        "kernels' plain versions)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    c = config_lib.default_cfg()
    config_lib.cfg_from_list(c, SETTINGS)

    imdb_te, roidb_te, _, _ = combined_roidb(
        'synth_test', training=False, use_flipped=False, data_dir=c.DATA_DIR)
    _, roidb_tr, _, _ = combined_roidb(
        'synth_train', training=False, use_flipped=False, data_dir=c.DATA_DIR)
    model, config = load_detector(args.checkpoint, args.way, args.shot,
                                  args.arch, c)
    pred = Predictor(model, config, device=device, postprocess=dict(
        config_lib.postprocess_kwargs(c), max_per_image=100 // args.way))
    pool = SupportPool(imdb_te.classes, args.shot, support_roidb=roidb_tr,
                       seed=0, pixel_means=c.PIXEL_MEANS,
                       exact_support_scale=c.TPU.EXACT_SUPPORT_SCALE,
                       target_size=c.TRAIN.SCALES[0])
    with tempfile.TemporaryDirectory() as out_dir:
        result = evaluate(pred, imdb_te, roidb_te, pool, args.way, c, out_dir)
    print(f'{args.way}-way {args.shot}-shot AP:',
          round(result['stats'][0], 4), 'AP50:', round(result['stats'][1], 4),
          flush=True)
    return result


if __name__ == '__main__':
    main(sys.argv[1:])
