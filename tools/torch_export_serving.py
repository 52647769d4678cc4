"""Export a checkpoint as a serving artifact of the PyTorch port
(dana_tpu_torch/serve.py; the port's counterpart of
tools/export_serving.py, with its flags).

Traces the predict step per query bucket and the support encoder with
torch.export, optionally int8-quantizing the detector first
(dana_tpu_torch/quant.py).  The artifact serves without the model code;
the weights stay in the checkpoint and travel as an argument.

    python tools/torch_export_serving.py --checkpath ckpt.dkpt \\
        --out artifacts/dana_r50 [--bs 8] [--way 2] [--shot 3] \\
        [--arch resnet50] [--quant tail|all] [--platforms cuda|cpu] \\
        [--buckets 608x1024,704x704] [--ascale 3|4] [--set KEY VALUE ...]

`--platforms` names the device the artifact serves on (default: the
card).  The programs are traced on the CPU and placed on that device
(serve.py `_retarget`), so `--platforms cuda` exports for the card on a
build host without one, `--quant` included, as the JAX tool's
`--platforms tpu` does on a CPU host.  The config maps as the port's
CLIs map theirs (dana_tpu_torch/utils/args.py): the built-in
cfgs/res50.yml values (`--cfg cfgs/res101_ls.yml` applies --ls's values;
the port reads no other YAML), the --ascale preset, then --set.  `--s2d` is refused, as the port's
CLIs refuse TPU.STEM_S2D.  Tested by tests/test_torch_port_serve.py.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--checkpath', required=True)
    ap.add_argument('--out', required=True)
    ap.add_argument('--bs', type=int, default=8)
    ap.add_argument('--way', type=int, default=2)
    ap.add_argument('--shot', type=int, default=3)
    ap.add_argument('--arch', default='resnet50')
    ap.add_argument('--quant', default=None, choices=('tail', 'all'))
    ap.add_argument('--s2d', action='store_true',
                    help='refused: the port has no space-to-depth stem')
    ap.add_argument('--platforms', nargs='*', default=None,
                    help='the device the artifact serves on: cuda (the '
                         'default) or cpu')
    ap.add_argument('--buckets', default=None,
                    help='comma list like 608x1024,704x704 '
                         '(default: TPU.SIZE_BUCKETS)')
    ap.add_argument('--cfg', dest='cfg_file', default=None,
                    help='cfgs/res50.yml (built in) or cfgs/res101_ls.yml')
    ap.add_argument('--set', dest='set_cfgs', nargs='*', default=None,
                    help='cfg key-value override pairs')
    ap.add_argument('--ascale', type=int, default=4, choices=(3, 4),
                    help='anchor-scale preset, as the CLIs (reference '
                         'utils.py:68-73); must match the checkpoint '
                         '(validated against the RPN head)')
    args = ap.parse_args(argv)

    from dana_tpu_torch import quant, serve
    from dana_tpu_torch.utils import checkpoint as ckpt_lib
    from dana_tpu_torch.utils import config as config_lib
    from dana_tpu_torch.utils.args import ASCALE_PRESETS
    from dana_tpu_torch.utils.weights import from_jax_params

    if args.s2d:
        raise SystemExit(f'--s2d: {serve.S2D_REFUSED}')
    platforms = args.platforms or ['cuda']
    if len(platforms) != 1:
        raise SystemExit(f'--platforms {platforms}: an artifact serves on '
                         'one device')
    backbones = {v: k for k, v in config_lib.BACKBONES.items()}
    if args.arch not in backbones:
        raise SystemExit(f'--arch {args.arch}: the port\'s trunks are '
                         f'{", ".join(backbones)}')
    c = config_lib.default_cfg()
    if args.cfg_file:
        name = os.path.basename(args.cfg_file)
        if name == 'res101_ls.yml':
            config_lib.cfg_from_list(c, config_lib.LARGE_SCALE)
        elif name != 'res50.yml':
            raise SystemExit(f'--cfg {args.cfg_file}: the port reads no '
                             'YAML; res50.yml is built in, res101_ls.yml '
                             'is --ls (pass other values with --set)')
    config_lib.cfg_from_list(c, ASCALE_PRESETS[args.ascale])
    if args.set_cfgs:          # explicit --set pairs win over the preset
        config_lib.cfg_from_list(c, args.set_cfgs)
    if c.TPU.STEM_S2D:
        raise SystemExit(f'TPU.STEM_S2D: {serve.S2D_REFUSED}')

    payload = ckpt_lib.read_checkpoint(args.checkpath)
    params = payload['model']
    # the checkpoint carries POOLING_MODE (reference train.py:100)
    c.POOLING_MODE = payload.get('pooling_mode') or c.POOLING_MODE
    # int8 serving also routes RoIAlign through the int8 path; --quant
    # overrides whatever the config said
    config = dataclasses.replace(
        config_lib.dana_config(c, args.way, args.shot,
                               backbone=backbones[args.arch]),
        roi_align_int8=bool(args.quant))

    # fail loudly if the anchor config disagrees with the checkpoint: the
    # RPN cls head has 2A output channels, so a mismatched --ascale would
    # export an artifact that decodes garbage proposals
    head_ch = params['RCNN_rpn']['RPN_cls_score']['weight'].shape[-1]
    if head_ch != 2 * config.num_anchors:
        raise SystemExit(
            f'anchor mismatch: checkpoint RPN head has {head_ch // 2} '
            f'anchors/position but ANCHOR_SCALES x ANCHOR_RATIOS gives '
            f'{config.num_anchors} — pass the --ascale/--set the '
            f'checkpoint was trained with')
    if args.quant:
        params = quant.quantize_params(params, scope=args.quant)
    model = from_jax_params(params, config)
    if args.buckets:
        buckets = tuple(tuple(int(v) for v in b.split('x'))
                        for b in args.buckets.split(','))
    else:
        buckets = tuple(tuple(b) for b in c.TPU.SIZE_BUCKETS)

    meta = serve.export_predictor(
        model, config, args.out, buckets=buckets, batch_size=args.bs,
        device=platforms[0], pp_kwargs=config_lib.postprocess_kwargs(c))
    total = sum(os.path.getsize(os.path.join(args.out, f))
                for f in os.listdir(args.out))
    print(f"exported {len(meta['buckets'])} bucket artifacts + encoder "
          f"to {args.out} ({total / 1e6:.1f} MB) for {meta['device']}"
          f"{' [int8 ' + args.quant + ']' if args.quant else ''}")
    return meta


if __name__ == '__main__':
    main()
