"""The port's model-description modules against the JAX package's:
``io/prototxt.py`` (the parser's trees on inline text covering every form
the templates use, malformed text raising in both, both surgeries), the
port Detector's convolution list against the one the JAX forward traces
(runs anywhere), ``tools/draw_net.py`` (the DOT text character for
character, both head modes) and ``ops/merge_prediction.py`` (rtol 1e-6).
The checks against the reference's own template files mirror
tests/test_prototxt_parity.py on the port and skip, as those do, where the
templates are absent."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from smallhardface_tpu.io import prototxt as jpt
from smallhardface_tpu.models import detector as jdm
from smallhardface_tpu.ops.merge_prediction import merge_prediction as jmerge
from smallhardface_tpu.tools import draw_net as jdraw
from smallhardface_tpu_torch.io import prototxt as tpt
from smallhardface_tpu_torch.models import detector as tdm
from smallhardface_tpu_torch.ops.merge_prediction import (
    merge_prediction as tmerge)
from smallhardface_tpu_torch.tools import draw_net as tdraw
import torch_threads  # noqa: F401
from tests.test_prototxt_parity import REF_MODELS

# every form of the text-format subset: colon-brace and brace messages,
# both quotes with escapes, enums, bools, repeated fields, comments,
# signed, fractional and exponent numbers
SNIPPETS = {
    "net": r"""
name: "VGG_face"   # a comment
input: 'data'
input_shape { dim: 1 dim: 3 dim: 224 dim: 224 }
layer {
  name: "conv1_1" type: "Convolution" bottom: "data" top: "conv1_1"
  param { lr_mult: 1 decay_mult: 1 } param { lr_mult: 2 decay_mult: 0 }
  convolution_param: { num_output: 64 pad: 1 kernel_size: 3
    weight_filler { type: "gaussian" std: 0.01 }
    bias_filler { type: 'constant' value: 0 } }
}
layer { name: "pool1" type: "Pooling" bottom: "conv1_1" top: "pool1"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
""",
    "scalars": r"""
a: -3 b: +4 c: .5 d: -1.25e-3 e: 2E+2 f: 7.
t: true u: false v: ENUM_VALUE
s1: "double \"quoted\" \\ string" s2: 'single \'quoted\''
r: 1 r: 2 r: 3, r: 4; # separators too
m { } m: { x: 1 }
""",
    "python_param": r"""
layer { name: "proposal" type: "Python"
  python_param { module: "rpn.proposal_layer" layer: "ProposalLayer"
    param_str: "{'feat_stride': [8, 8, 8], 'scales': [1, 2, 4]}" } }
""",
}
MALFORMED = ("a: {", "}", "a b", "a: 'open", "a: }", "a: @", "{ a: 1 }",
             "a { b: 1 ")


def plain(msg):
    """A Msg of either package as plain lists and dicts, each scalar with
    its type, so that 1, 1.0 and True differ."""
    if hasattr(msg, "fields"):
        return {k: [plain(v) for v in vals] for k, vals in msg.fields.items()}
    return (type(msg).__name__, msg)


@pytest.mark.parametrize("name", sorted(SNIPPETS))
def test_parser_trees_equal_jax(name):
    text = SNIPPETS[name]
    assert plain(tpt.parse_prototxt(text)) == plain(jpt.parse_prototxt(text))
    toks = list(tpt._tokenize(text))
    assert toks == list(jpt._tokenize(text))


@pytest.mark.parametrize("text", MALFORMED)
def test_malformed_text_raises_in_both(text):
    for mod in (jpt, tpt):
        with pytest.raises(ValueError):
            mod.parse_prototxt(text)


def _net_text(with_heads=True):
    """A template-shaped net: a backbone conv, conv4_fuse_final with its
    in-place ReLU, then head layers (the surgery's split point)."""
    heads = "".join(
        f'layer {{ name: "head_{k}" type: "Convolution" '
        f'bottom: "conv4_fuse_final" top: "head_{k}" '
        f'param {{ name: "head_w" lr_mult: 1 }} '
        f'param {{ name: "head_b" lr_mult: 2 decay_mult: 0 }} '
        f'convolution_param {{ num_output: 128 kernel_size: 3 pad: {k} '
        f'dilation: {k} }} }}\n' for k in (1, 2, 4)) if with_heads else ""
    return ('layer { name: "conv3_1" type: "Convolution" bottom: "data" '
            'top: "conv3_1" param { lr_mult: 1 } param { lr_mult: 2 } '
            'convolution_param { num_output: 256 kernel_size: 3 pad: 1 } }\n'
            'layer { name: "conv4_fuse_final" type: "Convolution" '
            'bottom: "conv4_fuse" top: "conv4_fuse_final" param { } '
            'convolution_param { num_output: 512 kernel_size: 3 pad: 1 } }\n'
            'layer { name: "conv4_fuse_final_relu" type: "ReLU" '
            'bottom: "conv4_fuse_final" top: "conv4_fuse_final" }\n' + heads)


@pytest.mark.parametrize("enable", [True, False])
@pytest.mark.parametrize("mults", [(2.0, 1.0), (3.5, 0.5)])
def test_surgeries_equal_jax(enable, mults):
    trees = []
    for mod in (jpt, tpt):
        net = mod.parse_prototxt(_net_text())
        net = mod.add_dimension_reduction(net, enable)
        net = mod.apply_mult_lr(net, *mults)
        specs = [mod.param_specs(layer) for layer in net.getlist("layer")]
        trees.append((plain(net), specs))
    assert trees[0] == trees[1]
    names = [v[1] for layer in trees[1][0]["layer"]
             for v in layer["name"]]
    assert ("conv4_fuse_final_dim_red" in names) == enable


def test_surgery_without_heads_raises_in_both():
    for mod in (jpt, tpt):
        with pytest.raises(ValueError):
            mod.add_dimension_reduction(
                mod.parse_prototxt(_net_text(with_heads=False)), True)


# ---------------------------------------------------------------------------
# The port Detector's convolutions against the JAX forward's
# ---------------------------------------------------------------------------

def port_convs(spec, hw=(64, 64)):
    """Every convolution one CPU forward of the port's Detector runs, in
    order: (parameter leaf, kh, kw, in channels, out channels, dilation,
    padding, groups, transposed), and the leaf's tensor identity (one per
    shared weight). Records F.conv2d / F.conv_transpose2d calls."""
    params = tdm.init_params(torch.Generator().manual_seed(0), spec)
    model = tdm.Detector(params, spec, "cpu")
    by_ptr = {t.data_ptr(): (name, t) for name, leaf in model.params.items()
              for k, t in leaf.items() if k == "w"}
    up = model.params["conv5_256_up"]["w"]
    seen = []
    real_conv, real_deconv = F.conv2d, F.conv_transpose2d

    def conv(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        name, t = by_ptr[w.data_ptr()]
        pad = padding if isinstance(padding, int) else padding[0]
        assert isinstance(padding, int) or len(set(padding)) == 1
        seen.append(((name, w.shape[2], w.shape[3], w.shape[1] * groups,
                      w.shape[0], dilation, pad, groups, False), id(t)))
        return real_conv(x, w, b, stride, padding, dilation, groups)

    def deconv(x, w, b=None, stride=1, padding=0, output_padding=0,
               groups=1, dilation=1):
        assert torch.equal(w, torch.flip(up, (2, 3)))
        seen.append((("conv5_256_up", w.shape[2], w.shape[3], w.shape[0],
                      w.shape[1] * groups, dilation, padding, groups, True),
                     id(up)))
        return real_deconv(x, w, b, stride, padding, output_padding, groups,
                           dilation)

    mp = pytest.MonkeyPatch()
    mp.setattr(F, "conv2d", conv)
    mp.setattr(F, "conv_transpose2d", deconv)
    try:
        x = torch.zeros((1, *hw, 3))
        with torch.inference_mode():
            model(x, hw)
    finally:
        mp.undo()
    return seen


def jax_convs(spec):
    """The same tuples for every conv of the traced JAX forward ("where"
    mode, the XLA stem), the transposed conv as Caffe's deconvolution
    (stride 2 as lhs dilation, padding k − 1 − p)."""
    shapes = jdm.param_shapes(spec)
    params = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s, jnp.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    x = jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda p, xx: jdm.forward(
        p, xx, spec, mask_mode="where"))(params, x)
    leaves = jax.tree_util.tree_flatten_with_path((params, x))[0]
    path_of = {id(v): tuple(getattr(p, "key", getattr(p, "idx", None))
                            for p in path)
               for (path, _), v in zip(leaves, jaxpr.jaxpr.invars)}
    out = []
    for eqn in jaxpr.jaxpr.eqns:
        if str(eqn.primitive) != "conv_general_dilated":
            continue
        leaf = path_of[id(eqn.invars[1])][1]
        kh, kw, ci, co = eqn.invars[1].aval.shape
        g = eqn.params["feature_group_count"]
        (pa, pb), (pc, pd) = eqn.params["padding"]
        assert pa == pb == pc == pd
        d = eqn.params["rhs_dilation"][0]
        deconv = eqn.params["lhs_dilation"] != (1, 1)
        pad = kh - 1 - pa if deconv else pa
        out.append(((leaf, kh, kw, ci * g, co, d, pad, g, deconv),
                    id(eqn.invars[1])))
    return out


@pytest.mark.parametrize("dd", [True, False])
def test_detector_convs_equal_jax_trace(dd):
    """Name, kernel, channels, dilation, padding, groups and the shared
    head of every convolution, in the order the two forwards run them."""
    spec = tdm.ModelSpec(different_dilation=dd)
    port = port_convs(spec)
    ref = jax_convs(jdm.ModelSpec(different_dilation=dd))
    assert [p for p, _ in port] == [r for r, _ in ref]
    # one weight tensor per leaf in both: the dilated heads share one
    for seq in (port, ref):
        ids = {}
        for desc, ident in seq:
            assert ids.setdefault(desc[0], ident) == ident, desc[0]
    if dd:
        assert [d for (n, *_, d, _p, _g, _t), _ in port
                if n == "head"] == list(tdm.HEAD_DILATIONS)


# ---------------------------------------------------------------------------
# The reference's template files (absent: skipped, as in
# tests/test_prototxt_parity.py)
# ---------------------------------------------------------------------------

def _templates():
    if not os.path.isdir(REF_MODELS):
        pytest.skip("reference templates not present")


def surgered(template, different_dilation, mults=None):
    net = tpt.load_prototxt(os.path.join(REF_MODELS, template))
    net = tpt.add_dimension_reduction(net, different_dilation)
    if mults is not None:
        net = tpt.apply_mult_lr(net, *mults)
    return net


def template_convs(net):
    """(name, kh, kw, in, out, dilation, pad, group, deconv) of every
    Convolution/Deconvolution layer, with its ParamSpecs, in file order,
    channels tracked through the blobs."""
    channels = {}
    for inp, shape in zip(net.getlist("input"), net.getlist("input_shape")):
        channels[inp] = shape.getlist("dim")[1]
    out = []
    for layer in net.getlist("layer"):
        ltype, tops = layer.get("type"), layer.getlist("top")
        bottoms = layer.getlist("bottom")
        if ltype == "Python":
            for t in tops:
                channels[t] = 3 if t == "data" else None
        elif ltype in ("Convolution", "Deconvolution"):
            cp = layer.get("convolution_param")
            k = cp.getlist("kernel_size")[0]
            co = cp.get("num_output")
            out.append(((layer.get("name"), k, k, channels[bottoms[0]], co,
                         (cp.getlist("dilation") or [1])[0],
                         (cp.getlist("pad") or [0])[0], cp.get("group", 1),
                         ltype == "Deconvolution"),
                        tpt.param_specs(layer)))
            channels[tops[0]] = co
        elif ltype == "Concat":
            ch = [channels[b] for b in bottoms]
            axis = layer.get("concat_param").get("axis", 1)
            channels[tops[0]] = sum(ch) if axis == 1 else ch[0]
        elif bottoms and tops:
            channels[tops[0]] = channels.get(bottoms[0])
    return out


def test_template_reader_on_inline_net():
    """The reader the template checks use, on inline text: channels from
    the input shape, ParamSpecs with Caffe's defaults."""
    net = tpt.parse_prototxt(SNIPPETS["net"])
    (desc, specs), = template_convs(net)
    assert desc == ("conv1_1", 3, 3, 3, 64, 1, 1, 1, False)
    assert specs == [("", 1.0, 1.0), ("", 2.0, 0.0)]


def _leaf(name, dd):
    return "head" if dd and name.startswith("head_") else name


@pytest.mark.parametrize("dd,template", [
    (True, "test_different_dilation_template.prototxt"),
    (False, "test_template.prototxt")])
def test_template_convs_equal_detector(dd, template):
    _templates()
    spec = tdm.ModelSpec(different_dilation=dd)
    tmpl = [(_leaf(d[0], dd),) + d[1:] for d, _ in template_convs(
        surgered(template, dd))]
    port = [d for d, _ in port_convs(spec)]
    assert sorted(tmpl) == sorted(port)
    assert len(tmpl) == (27 if dd else 20)


@pytest.mark.parametrize("dd", [True, False])
@pytest.mark.parametrize("mults", [(2.0, 1.0), (3.5, 0.5)])
def test_template_multipliers_equal_port(dd, mults):
    _templates()
    template = ("train_different_dilation_template.prototxt" if dd
                else "train_template.prototxt")
    spec = tdm.ModelSpec(different_dilation=dd, backbone_lr_mult=mults[0],
                         head_lr_mult=mults[1])
    lr, decay = tdm.param_multipliers(spec)
    seen = set()
    for desc, specs in template_convs(surgered(template, dd, mults)):
        leaf = _leaf(desc[0], dd)
        seen.add(leaf)
        for field, (_, lr_mult, decay_mult) in zip(("w", "b"), specs):
            assert lr[leaf][field] == pytest.approx(lr_mult), desc[0]
            assert decay[leaf][field] == pytest.approx(decay_mult), desc[0]
    assert seen == set(lr)


# ---------------------------------------------------------------------------
# draw_net and merge_prediction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dd", [True, False])
def test_draw_net_dot_equals_jax(dd, tmp_path):
    want = jdraw.spec_to_dot(jdm.ModelSpec(different_dilation=dd))
    assert tdraw.spec_to_dot(tdm.ModelSpec(different_dilation=dd)) == want
    out = str(tmp_path / "net.txt")
    tdraw.main(["--out", out] + ([] if dd else ["--single-head"]))
    with open(out) as f:
        assert f.read() == want


@pytest.mark.parametrize("n,h,w", [(1, 3, 5), (3, 4, 6), (5, 1, 7)])
def test_merge_prediction_equals_jax(n, h, w):
    rng = np.random.RandomState(n)
    maps = (rng.randn(n, 2, h, w) * 4).astype(np.float32)
    want = np.asarray(jmerge(maps))
    got = tmerge(torch.from_numpy(maps))
    assert got.shape == want.shape == (1, 2, h, w)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tmerge(maps).numpy(), want, rtol=1e-6)
