"""The constants the serving slice needs, copied from the JAX package's
config defaults and `cfgs/res50.yml` (the JAX config module is not
imported: the port stands alone).

`get_model('res50', way, shot)` mirrors the repo's root `utils.get_model`
for the DAnA detector: ResNet-50 trunk, BA block on, concat attention,
RoIAlign pooling, float32 compute.
"""

from __future__ import annotations

# BGR Caffe pixel means, subtracted from raw uint8 queries on the device
PIXEL_MEANS = (102.9801, 115.9465, 122.7717)

ANCHOR_SCALES = (8, 16, 32)
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
FEAT_STRIDE = 16
POOLING_SIZE = 7                  # RoIAlign (cfgs/res50.yml POOLING_MODE)

TEST_NMS = 0.3                    # detection NMS threshold
TEST_RPN_NMS_THRESH = 0.7
TEST_RPN_PRE_NMS_TOP_N = 6000
TEST_RPN_POST_NMS_TOP_N = 300
TEST_SCORE_THRESH = 0.05
TEST_MAX_PER_IMAGE = 100
# cap on the candidates fed to the proposal NMS (TPU.NMS_MAX_INPUT)
NMS_MAX_INPUT = 12000

BBOX_NORMALIZE_MEANS = (0.0, 0.0, 0.0, 0.0)
BBOX_NORMALIZE_STDS = (0.1, 0.1, 0.2, 0.2)

_ARCHS = {'res50': 'resnet50'}


def get_model(name='res50', way=2, shot=3, seed=1996):
    """-> (DanaConfig, numpy param tree in the JAX layout), the `way`-way
    `shot`-shot DAnA detector (BA block on) on a ResNet-50 trunk with
    random weights from `seed`."""
    from dana_tpu_torch.models import dana
    if name not in _ARCHS:
        raise ValueError(f'network {name!r} is not part of the port '
                         f'(have {sorted(_ARCHS)})')
    config = dana.DanaConfig(
        n_way=way, n_shot=shot, arch=_ARCHS[name],
        semantic_enhance=True,
        anchor_scales=ANCHOR_SCALES, anchor_ratios=ANCHOR_RATIOS,
        pooling_size=POOLING_SIZE,
        test_pre_nms=TEST_RPN_PRE_NMS_TOP_N,
        test_post_nms=TEST_RPN_POST_NMS_TOP_N,
        rpn_nms_thresh=TEST_RPN_NMS_THRESH, nms_cap=NMS_MAX_INPUT,
        bbox_normalize_means=BBOX_NORMALIZE_MEANS,
        bbox_normalize_stds=BBOX_NORMALIZE_STDS,
        pixel_means=PIXEL_MEANS)
    return config, dana.init_params(config, seed=seed)
