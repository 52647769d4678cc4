"""The port's trunks against the JAX package on the CPU: every ResNet of
`ARCH_LAYERS` (the basic-block ResNet-18/34 too, which the detector does
not run) and VGG16, their weight draws, the detector's weight bridges on
ResNet-101 and VGG16, the torchvision VGG16 bridge, and which trunk
parameters train.

The trunks run at 1 x 128 x 160 with every residual branch live (the
SkipInit-zeroed last conv drawn again, at a fifth of He's scale, so the
deep tables stay in range) and unit-scale BN statistics; outputs are held
to 1e-4 of their largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dana_tpu.engine import optim as joptim
from dana_tpu.models import dana as jdana
from dana_tpu.models import resnet as jresnet
from dana_tpu.models import vgg as jvgg
from dana_tpu.models.layers import to_jnp
from dana_tpu.utils.torch_import import export_dana_state_dict

from dana_tpu_torch.engine import optim as toptim
from dana_tpu_torch.models import dana as tdana
from dana_tpu_torch.models import resnet as tresnet
from dana_tpu_torch.models import vgg as tvgg
from dana_tpu_torch.utils import weights as tweights
from test_torch_port_model import _leaves

TOL = 1e-4
ARCHS = list(tresnet.ARCH_LAYERS)


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs several test processes at
    once."""
    was = torch.get_num_threads()
    torch.set_num_threads(min(2, was))
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope='module')
def vgg_tree():
    """The JAX package's VGG16 draw (fc6 alone is 103M weights): drawn once,
    read by every VGG16 case, never written."""
    return jvgg.init_params(seed=4)


def _live(tree, seed):
    """Every zeroed conv weight drawn again (He-normal / 5) and every BN
    given unit-scale statistics, in place; -> the tree."""
    rng = np.random.default_rng(seed)

    def walk(node):
        for v in node.values():
            if not isinstance(v, dict):
                continue
            if 'running_var' in v:
                c = v['running_var'].shape[0]
                v['weight'] = rng.normal(1.0, 0.1, c).astype(np.float32)
                v['bias'] = rng.normal(0.0, 0.1, c).astype(np.float32)
                v['running_mean'] = rng.normal(0.0, 0.5, c).astype(np.float32)
                v['running_var'] = (rng.random(c) + 0.5).astype(np.float32)
            elif 'weight' in v and v['weight'].ndim == 4 \
                    and not v['weight'].any():
                w = v['weight']
                std = np.sqrt(2.0 / (w.shape[0] * w.shape[1] * w.shape[3]))
                v['weight'] = rng.normal(0.0, std / 5, w.shape) \
                    .astype(np.float32)
            else:
                walk(v)
    walk(tree)
    return tree


def _query(seed, hw=(128, 160)):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 50, (1, *hw, 3)).astype(np.float32)


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


def _model(tree, module):
    module.load_state_dict({k: tweights._from_jax_layout(v)
                            for k, v in _leaves(tree)}, strict=True)
    return module.eval()


@pytest.mark.parametrize('arch', ARCHS)
def test_init_params_draw_as_jax(arch):
    want = dict(_leaves(jresnet.init_params(arch, seed=4)))
    got = dict(_leaves(tresnet.init_params(arch, seed=4)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    last = 'conv2' if jresnet.ARCH_LAYERS[arch][0] == 'basic' else 'conv3'
    assert not got[f'layer3.1.{last}.weight'].any()      # SkipInit


def test_vgg_init_params_draw_as_jax(vgg_tree):
    want = dict(_leaves(vgg_tree))
    got = dict(_leaves(tvgg.init_params(seed=4)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize('arch', ARCHS)
def test_resnet_base_and_top(arch):
    """RCNN_base (conv1..layer3) and RCNN_top (layer4) of each table."""
    tree = _live(jresnet.init_params(arch, seed=1), seed=2)
    model = _model(tree, tresnet.ResNet(arch))
    x = _query(3)
    jt = to_jnp(tree)
    want = jax.jit(lambda p, x: jresnet.base_forward(x, p, arch))(
        jt, jnp.asarray(x))
    with torch.no_grad():
        got = tresnet.base_forward(torch.from_numpy(x), model)
        _close(got, want)
        top = tresnet.top_forward(got, model)
    _close(top, jax.jit(lambda p, x: jresnet.top_forward(x, p, arch))(
        jt, jnp.asarray(got.numpy())))
    width = 256 if jresnet.ARCH_LAYERS[arch][0] == 'basic' else 1024
    assert got.shape == (1, 8, 10, width)


def test_vgg_base_and_tail(vgg_tree):
    """conv1_1..conv5_3 with four floor pools (an odd map on the way) and
    fc6 / fc7 on CHW-flattened RoI features."""
    tree = vgg_tree
    model = _model(tree, tvgg.VGG16())
    x = _query(3, hw=(136, 168))             # 17 x 21 after three pools
    jt = to_jnp(tree)
    want = jax.jit(jvgg.base_forward)(jnp.asarray(x), jt)
    rois = np.random.default_rng(5).normal(0, 1, (3, 7, 7, 512)) \
        .astype(np.float32)
    with torch.no_grad():
        got = tvgg.base_forward(torch.from_numpy(x), model)
        tail = tvgg.tail_forward(torch.from_numpy(rois), model)
    assert got.shape == (1, 8, 10, 512)
    _close(got, want)
    _close(tail, jax.jit(jvgg.tail_forward)(jnp.asarray(rois), jt))


def _trunk(arch, vgg_tree):
    """The trunk tree to build a detector on: the fixture's VGG16 draw, or
    None (the detector draws its ResNet)."""
    return vgg_tree if arch == 'vgg16' else None


def _dana_configs(arch):
    kw = dict(n_way=2, n_shot=2, semantic_enhance=True, arch=arch)
    return (jdana.DanaConfig(use_pallas_attention=False, **kw),
            tdana.DanaConfig(**kw))


@pytest.mark.parametrize('arch', ['resnet101', 'resnet152', 'vgg16'])
def test_detector_init_params_draw_as_jax(arch):
    jconf, tconf = _dana_configs(arch)
    want = dict(_leaves(jdana.init_params(jconf, seed=6)))
    got = dict(_leaves(tdana.init_params(tconf, seed=6)))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tconf.feat_dim == jconf.feat_dim
    assert tconf.tail_dim == jconf.tail_dim


@pytest.mark.parametrize('arch', ['resnet101', 'vgg16'])
def test_weight_bridges_round_trip(arch, vgg_tree):
    """from_jax_params fills every parameter and buffer of the detector on
    the trunk, to_jax_params gives the tree back, and the reference state
    dict the JAX package exports (RCNN_base / RCNN_top prefixes on a
    ResNet) loads into the same module."""
    jconf, tconf = _dana_configs(arch)
    params = jdana.init_params(jconf, seed=7,
                               backbone_params=_trunk(arch, vgg_tree))
    if arch != 'vgg16':
        _live(params, seed=8)
    model = tweights.from_jax_params(params, tconf)
    flat = dict(_leaves(params))
    assert set(model.state_dict()) == set(flat)
    back = dict(_leaves(tweights.to_jax_params(model)))
    assert back.keys() == flat.keys()
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    sd = export_dana_state_dict(params)
    assert any(k.startswith('RCNN_base.6.22.') for k in sd) == \
        (arch == 'resnet101')
    ref = tweights.load_reference_state_dict(
        {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, tconf)
    for k, v in model.state_dict().items():
        assert torch.equal(ref.state_dict()[k], v), k


def test_torchvision_vgg16_bridge(vgg_tree):
    """A torchvision vgg16 state dict (OIHW convs, [out, in] linears, the
    1000-way classifier.6) gives the JAX package's convert_torch_vgg16
    tree, which the detector then takes as its trunk."""
    rng = np.random.default_rng(9)
    sd = {}
    for k, v in _leaves(vgg_tree):
        v = v.transpose(3, 2, 0, 1) if v.ndim == 4 else \
            (v.T if v.ndim == 2 else v + rng.normal(0, 1, v.shape))
        sd[k] = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    sd['classifier.6.weight'] = torch.zeros(1000, 4096)
    sd['classifier.6.bias'] = torch.zeros(1000)
    want = dict(_leaves(jvgg.convert_torch_vgg16(sd)))
    tree = tweights.torchvision_vgg16_params(sd)
    got = dict(_leaves(tree))
    assert got.keys() == want.keys()
    assert not any(k.startswith('classifier.6') for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _, tconf = _dana_configs('vgg16')
    model = tweights.from_jax_params(
        tdana.init_params(tconf, seed=1, backbone_params=tree), tconf)
    assert torch.equal(model.backbone.features['0'].weight,
                       sd['features.0.weight'])


@pytest.mark.parametrize('arch', ['resnet101', 'vgg16'])
def test_trainable_trunk_matches_jax(arch, vgg_tree):
    """freeze_fixed against trainable_mask: on ResNet-101 the stem and
    layer1 freeze; VGG16's trunk trains whole, fc6 and fc7 included."""
    jconf, tconf = _dana_configs(arch)
    params = jdana.init_params(jconf, seed=0,
                               backbone_params=_trunk(arch, vgg_tree))
    model = toptim.freeze_fixed(tweights.from_jax_params(params, tconf), 1)
    want = {k for k, t in _leaves(joptim.trainable_mask(
        jax.tree.map(np.asarray, params), fixed_blocks=1)) if t}
    got = {n for n, p in model.named_parameters() if p.requires_grad}
    assert got == want
    trunk = {n for n in got if n.startswith('backbone.')}
    if arch == 'vgg16':
        assert len(trunk) == 2 * (len(tvgg.CONV_IDX) + 2)
    else:
        assert 'backbone.layer3.22.conv3.weight' in trunk
        assert 'backbone.conv1.weight' not in trunk
        assert not any(n.startswith('backbone.layer1.') for n in trunk)


def test_basic_block_arch_is_refused_by_the_detector():
    with pytest.raises(NotImplementedError, match='256 channels'):
        tdana.DanaConfig(arch='resnet34')



@pytest.mark.parametrize('arch', tdana.ARCHES)
def test_trunk_members_agree_with_jax_config(arch):
    """Each trunk of `dana.TRUNKS`: its module's channels, those of the
    table and JAX's `DanaConfig` agree, and its `tail` maps 7 x 7 pooled
    rois to [N, tail_dim]."""
    spec = tdana.TRUNKS[arch]
    module = spec.module()
    jconf = jdana.DanaConfig(arch=arch)
    assert (module.feat_dim, module.tail_dim) == (spec.feat_dim,
                                                  spec.tail_dim)
    assert (spec.feat_dim, spec.tail_dim) == (jconf.feat_dim, jconf.tail_dim)
    with torch.no_grad():
        tail = module.tail(torch.zeros(2, 7, 7, spec.feat_dim))
    assert tail.shape == (2, spec.tail_dim)
