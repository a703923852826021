"""Protobuf text-format (prototxt) parser + the reference's programmatic
net surgery, used to check the built model against the *actual* template
bytes shipped by the reference.

The port's own copy of ``smallhardface_tpu/io/prototxt.py`` (:25-285):
the same ``Msg`` tree, tokenizer, ``parse_prototxt``, ``load_prototxt``,
``add_dimension_reduction``, ``apply_mult_lr`` and ``param_specs``, so the
port reads the templates without importing the JAX package.

The reference defines its model graph as Caffe prototxt templates (its
models/*_template.prototxt) that its lib/prototxt/manipulate.py then
rewrites (dim-reduction insert, lr-multiplier scaling) before Net
construction.  This module parses that
text format into a generic tree (no caffe_pb2 dependency) and replays the
manipulate.py surgery, so tests can assert — layer by layer — that
models.detector builds the same network the reference would have.

Only the text-format subset the templates use is supported:
  field: value            scalars (number / "string" / 'string' / enum / bool)
  field { ... }           nested messages
  field: { ... }          nested messages, colon form (caffe accepts both)
  # comment               to end of line
Repeated fields accumulate in order, as protobuf text-format semantics
require.
"""

from __future__ import annotations


class Msg:
    """A parsed protobuf text-format message: field name -> list of values
    (scalars or nested Msg), in file order."""

    def __init__(self):
        self.fields = {}

    def add(self, key, value):
        self.fields.setdefault(key, []).append(value)

    def getlist(self, key):
        return self.fields.get(key, [])

    def get(self, key, default=None):
        vals = self.fields.get(key)
        if not vals:
            return default
        if len(vals) > 1:
            raise ValueError(f"field {key!r} is repeated ({len(vals)}×); "
                             "use getlist")
        return vals[0]

    def __contains__(self, key):
        return key in self.fields

    def __repr__(self):
        return f"Msg({self.fields!r})"


def _tokenize(text):
    """Yield (kind, value) with kind in {'ident','string','number','punct'}."""
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in " \t\r\n,;":
            i += 1
            continue
        if c == "#":
            while i < n and text[i] != "\n":
                i += 1
            continue
        if c in "{}:":
            yield ("punct", c)
            i += 1
            continue
        if c in "'\"":
            quote = c
            j = i + 1
            buf = []
            while j < n and text[j] != quote:
                if text[j] == "\\" and j + 1 < n:
                    buf.append(text[j + 1])
                    j += 2
                else:
                    buf.append(text[j])
                    j += 1
            if j >= n:
                raise ValueError("unterminated string literal")
            yield ("string", "".join(buf))
            i = j + 1
            continue
        if c.isdigit() or c in "+-." and i + 1 < n and (
                text[i + 1].isdigit() or text[i + 1] == "."):
            j = i
            while j < n and (text[j].isdigit() or text[j] in "+-.eE"):
                j += 1
            yield ("number", text[i:j])
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (text[j].isalnum() or text[j] == "_"):
                j += 1
            yield ("ident", text[i:j])
            i = j
            continue
        raise ValueError(f"unexpected character {c!r} at offset {i}")


def _parse_number(tok):
    try:
        return int(tok)
    except ValueError:
        return float(tok)


def parse_prototxt(text) -> Msg:
    """Parse prototxt text into a Msg tree."""
    tokens = list(_tokenize(text))
    pos = [0]

    def peek():
        return tokens[pos[0]] if pos[0] < len(tokens) else None

    def advance():
        tok = tokens[pos[0]]
        pos[0] += 1
        return tok

    def parse_message(closing):
        msg = Msg()
        while True:
            tok = peek()
            if tok is None:
                if closing:
                    raise ValueError("unexpected EOF inside message")
                return msg
            if tok == ("punct", "}"):
                if not closing:
                    raise ValueError("unmatched '}'")
                advance()
                return msg
            kind, name = advance()
            if kind != "ident":
                raise ValueError(f"expected field name, got {tok}")
            tok = peek()
            if tok == ("punct", ":"):
                advance()
                tok = peek()
                if tok == ("punct", "{"):      # colon-brace form
                    advance()
                    msg.add(name, parse_message(True))
                    continue
                kind, value = advance()
                if kind == "number":
                    msg.add(name, _parse_number(value))
                elif kind == "string":
                    msg.add(name, value)
                elif kind == "ident":
                    if value == "true":
                        msg.add(name, True)
                    elif value == "false":
                        msg.add(name, False)
                    else:
                        msg.add(name, value)   # enum, e.g. MAX
                else:
                    raise ValueError(f"bad value for {name}: {value!r}")
            elif tok == ("punct", "{"):
                advance()
                msg.add(name, parse_message(True))
            else:
                raise ValueError(f"expected ':' or '{{' after {name!r}")

    return parse_message(False)


def load_prototxt(path) -> Msg:
    with open(path) as f:
        return parse_prototxt(f.read())


# ---------------------------------------------------------------------------
# The manipulate.py surgery, replayed on the parsed tree.
# ---------------------------------------------------------------------------

def _simple_conv_layer(name, bottom, top, num_output, kernel_size, pad,
                       dilation=1, std=0.01, bias=0.0, param_type=0):
    """Msg equivalent of manipulate._simple_conv_layer
    (the reference's lib/prototxt/manipulate.py:89-142)."""
    layer = Msg()
    layer.add("name", name)
    layer.add("type", "Convolution")
    layer.add("bottom", bottom)
    layer.add("top", top)
    cp = Msg()
    cp.add("num_output", num_output)
    cp.add("pad", pad)
    cp.add("kernel_size", kernel_size)
    wf = Msg()
    wf.add("type", "gaussian")
    wf.add("std", std)
    cp.add("weight_filler", wf)
    bf = Msg()
    bf.add("type", "constant")
    bf.add("value", bias)
    cp.add("bias_filler", bf)
    cp.add("dilation", dilation)
    layer.add("convolution_param", cp)
    specs = {  # param_type -> ((w_lr, w_decay), (b_lr, b_decay))
        1: ((1.0, 0.0), (2.0, 0.0)),
        2: ((1.0, 1.0), (2.0, 0.0)),
        3: ((10.0, 1.0), (20.0, 0.0)),
        4: ((1.0, 1.0), (2.0, 1.0)),
    }
    for lr, decay in specs.get(param_type, ((None, None), (None, None))):
        p = Msg()
        if lr is not None:
            p.add("lr_mult", lr)
            p.add("decay_mult", decay)
        layer.add("param", p)
    return layer


def _simple_relu_layer(name, bottom, top=None):
    layer = Msg()
    layer.add("name", name)
    layer.add("type", "ReLU")
    layer.add("bottom", bottom)
    layer.add("top", top if top is not None else bottom)
    return layer


def _head_split(layers):
    """Index of the first layer whose name starts with 'head'
    (manipulate.py:155-156,169-170)."""
    for i, layer in enumerate(layers):
        if str(layer.get("name", "")).startswith("head"):
            return i
    raise ValueError("no layer named head*")


def add_dimension_reduction(net: Msg, enable: bool) -> Msg:
    """Replay manipulate._add_dimension_reduction (manipulate.py:166-188):
    rename conv4_fuse_final's top to *_tmp (with its in-place ReLU) and
    insert a 128-ch 3×3 conv + ReLU producing the 'conv4_fuse_final' blob
    the heads consume."""
    if not enable:
        return net
    layers = net.getlist("layer")
    split = _head_split(layers)
    conv = layers[split - 2]
    if conv.get("name") != "conv4_fuse_final":
        raise AssertionError(
            f"expected conv4_fuse_final at split-2, got {conv.get('name')}")
    conv.fields["top"][0] += "_tmp"
    relu = layers[split - 1]
    relu.fields["bottom"][0] += "_tmp"
    relu.fields["top"][0] += "_tmp"
    new_layers = layers[:split] + [
        _simple_conv_layer("conv4_fuse_final_dim_red",
                           "conv4_fuse_final_tmp", "conv4_fuse_final",
                           128, 3, 1, param_type=4),
        _simple_relu_layer("conv4_fuse_final_dim_red_relu",
                           "conv4_fuse_final"),
    ] + layers[split:]
    net.fields["layer"] = new_layers
    return net


def apply_mult_lr(net: Msg, backbone_mult: float, head_mult: float) -> Msg:
    """Replay manipulate._apply_mult_lr (manipulate.py:154-163): scale every
    ParamSpec lr_mult by BACKBONE_MULT before the first head* layer and by
    HEAD_MULT from it on.  Unset lr_mult reads as the proto default 1.0."""
    layers = net.getlist("layer")
    split = _head_split(layers)
    for i, layer in enumerate(layers):
        mult = backbone_mult if i < split else head_mult
        for p in layer.getlist("param"):
            lr = p.get("lr_mult", 1.0)
            p.fields["lr_mult"] = [lr * mult]
    return net


def param_specs(layer: Msg):
    """ParamSpec list [(shared_name, lr_mult, decay_mult)] with proto
    defaults ('', 1.0, 1.0) for unset fields (caffe.proto ParamSpec)."""
    out = []
    for p in layer.getlist("param"):
        out.append((p.get("name", ""), float(p.get("lr_mult", 1.0)),
                    float(p.get("decay_mult", 1.0))))
    return out
