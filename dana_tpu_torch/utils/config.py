"""The constants the serving and training slices need, copied from the
JAX package's config defaults and `cfgs/res50.yml` (the JAX config module
is not imported: the port stands alone).

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

# training: RPN anchor targets and proposals (cfg.TRAIN)
TRAIN_RPN_BATCHSIZE = 256
TRAIN_RPN_FG_FRACTION = 0.5
TRAIN_RPN_POSITIVE_OVERLAP = 0.7
TRAIN_RPN_NEGATIVE_OVERLAP = 0.3
TRAIN_RPN_PRE_NMS_TOP_N = 12000
TRAIN_RPN_POST_NMS_TOP_N = 2000
# TRAIN.RPN_NMS_THRESH is TEST_RPN_NMS_THRESH's 0.7: the model has one field
# training: R-CNN roi sampling
TRAIN_BATCH_SIZE = 128            # rois per image
TRAIN_FG_FRACTION = 0.25
TRAIN_FG_THRESH = 0.5
TRAIN_BG_THRESH_HI = 0.5
TRAIN_BG_THRESH_LO = 0.1
# training: optimizer (torch SGD semantics, per-group bias rules)
TRAIN_LEARNING_RATE = 0.001
TRAIN_MOMENTUM = 0.9
TRAIN_WEIGHT_DECAY = 0.0005
TRAIN_DOUBLE_BIAS = True
TRAIN_BIAS_DECAY = False
FIXED_BLOCKS = 1                  # conv1/bn1 and layer1 frozen (RESNET)

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
        train_pre_nms=TRAIN_RPN_PRE_NMS_TOP_N,
        train_post_nms=TRAIN_RPN_POST_NMS_TOP_N,
        test_pre_nms=TEST_RPN_PRE_NMS_TOP_N,
        test_post_nms=TEST_RPN_POST_NMS_TOP_N,
        rpn_nms_thresh=TEST_RPN_NMS_THRESH, nms_cap=NMS_MAX_INPUT,
        rpn_batchsize=TRAIN_RPN_BATCHSIZE,
        rpn_fg_fraction=TRAIN_RPN_FG_FRACTION,
        rpn_pos_overlap=TRAIN_RPN_POSITIVE_OVERLAP,
        rpn_neg_overlap=TRAIN_RPN_NEGATIVE_OVERLAP,
        rois_per_image=TRAIN_BATCH_SIZE, fg_fraction=TRAIN_FG_FRACTION,
        fg_thresh=TRAIN_FG_THRESH, bg_thresh_hi=TRAIN_BG_THRESH_HI,
        bg_thresh_lo=TRAIN_BG_THRESH_LO,
        bbox_normalize_means=BBOX_NORMALIZE_MEANS,
        bbox_normalize_stds=BBOX_NORMALIZE_STDS,
        pixel_means=PIXEL_MEANS)
    return config, dana.init_params(config, seed=seed)
