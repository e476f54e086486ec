"""A model bundle's normalised softmax forward in TensorFlow ops, for the
TFLite export (``to_tflite``).

The JAX package builds this forward with jax2tf from its flax modules. The
port has no JAX, so it writes the same function in TF ops from the
bundle's flax-layout arrays (``p/...`` parameters, ``c/batch_stats/...``
statistics), which are already in TF's layouts (HWIO convolution kernels,
(in, out) dense kernels, NHWC activations):

    softmax(net((x - norm_mean) / sqrt(norm_var + 1e-6)))

with input spec ``(1, *input_shape)``, the prepared input of one sample as
the trainer's ``_prepare_input`` gives it (NHWC for the CNN families), so a
file's input tensor matches the JAX package's. ``net`` is each family of
``models/deep.py`` at inference (dropout off, BatchNorm at its running
statistics):

- ``mlp``: Dense + ReLU layers, then the logits;
- ``cnn`` / ``distillation_cnn``: 3x3 SAME convolutions (flax's SAME: the
  odd padding goes after; an explicit pad, see ``_Net.conv``), ReLU, a 2x2
  max pool after each
  block that does not stride, global average pool, Dense(128) + ReLU,
  logits;
- ``ds_cnn``: the stem, an optional 2x2 pool, depthwise 3x3 + pointwise 1x1
  units, BatchNorm epsilon 1e-5 when the bundle has one;
- ``rnn``: flax's ``OptimizedLSTMCell`` (gates i, f, g, o; input kernels
  without bias, recurrent kernels with one) run forward and backward over
  the static sequence length, unrolled (no TFLite ``WHILE``);
- ``transformer``: flax's multi-head attention (the query scaled by
  1/sqrt(head_dim) before the dot product), LayerNorm epsilon 1e-6 with
  flax's E[x^2] - E[x]^2 variance;
- ``efficientnet_teacher``: ``square_resize`` as two constant matrices (the
  zero padding and the bilinear resize, antialiased when it shrinks, are
  linear in the image), then EfficientNet-B0 (silu, squeeze-excite,
  BatchNorm epsilon 1e-3) and the head.

TensorFlow is imported inside the functions, never when this module is
imported: the port imports on a machine without it.
"""

from __future__ import annotations

import numpy as np

from ..models.backbones import EFFNET_B0_CONFIG
from ..models.layers import same_padding

_STATS = "c/batch_stats/"


def tensorflow():
    """The ``tensorflow`` module, or an ImportError that names it."""
    try:
        import tensorflow as tf
    except ImportError as exc:
        raise ImportError(
            "TensorFlow is not installed: the TFLite export and interpreter (compilation/to_tflite.py, "
            "the edge simulator's .tflite models, compile_xla --tflite) need the tensorflow package") from exc
    return tf


class _Net:
    """The TF ops of one bundle: ``const(key)`` is a flax-layout array as a
    float32 constant."""

    def __init__(self, tf, arch: dict, flat: dict[str, np.ndarray]) -> None:
        self.tf, self.arch, self.flat = tf, arch, flat

    def const(self, key: str):
        return self.tf.constant(np.asarray(self.flat[key], np.float32))

    def dense(self, x, path: str):
        return self.tf.matmul(x, self.const(f"p/{path}/kernel")) + self.const(f"p/{path}/bias")

    def conv(self, x, path: str, stride: int = 1, bias: bool = True):
        """A flax ``Conv`` with SAME padding; a (kh, kw, 1, C) kernel on C
        channels is depthwise. The padding is an explicit PAD before a VALID
        convolution (flax's SAME amounts, ``layers.same_padding``): TFLite's
        XNNPACK delegate, the interpreter's default on a CPU, miscomputes a
        SAME convolution whose stride exceeds its kernel (stride 4, 3x3)."""
        tf = self.tf
        kernel = np.asarray(self.flat[f"p/{path}/kernel"], np.float32)
        (kh, kw), (h, w) = kernel.shape[:2], (int(x.shape[1]), int(x.shape[2]))
        pads = [[0, 0], list(same_padding(h, stride, kh)), list(same_padding(w, stride, kw)), [0, 0]]
        if any(a or b for a, b in pads):
            x = tf.pad(x, pads)
        if kernel.shape[2] == 1 and x.shape[-1] != 1:
            y = tf.nn.depthwise_conv2d(x, tf.constant(kernel.transpose(0, 1, 3, 2)), [1, stride, stride, 1], "VALID")
        else:
            y = tf.nn.conv2d(x, tf.constant(kernel), stride, "VALID")
        return y + self.const(f"p/{path}/bias") if bias else y

    def batch_norm(self, x, path: str, eps: float):
        """flax ``BatchNorm`` at its running statistics: (x - mean) *
        (rsqrt(var + eps) * scale) + bias."""
        mean = np.asarray(self.flat[f"{_STATS}{path}/mean"], np.float32)
        var = np.asarray(self.flat[f"{_STATS}{path}/var"], np.float32)
        mul = (1.0 / np.sqrt(var + np.float32(eps))).astype(np.float32) * np.asarray(self.flat[f"p/{path}/scale"],
                                                                                      np.float32)
        return (x - mean) * mul + self.const(f"p/{path}/bias")

    def layer_norm(self, x, path: str, eps: float = 1e-6):
        tf = self.tf
        mean = tf.reduce_mean(x, -1, keepdims=True)
        var = tf.maximum(tf.reduce_mean(x * x, -1, keepdims=True) - mean * mean, 0.0)
        return (x - mean) * (tf.math.rsqrt(var + eps) * self.const(f"p/{path}/scale")) + self.const(f"p/{path}/bias")


def _mlp(net: _Net, x):
    tf = net.tf
    n = len(net.arch["hidden_units"])
    for i in range(n):
        x = tf.nn.relu(net.dense(x, f"Dense_{i}"))
    return net.dense(x, f"Dense_{n}")


def _cnn(net: _Net, x):
    tf, arch = net.tf, net.arch
    first, second = arch.get("first_stride", 1), arch.get("second_stride", 1)
    for i in range(len(arch["filters"])):
        stride = first if i == 0 else second if i == 1 else 1
        x = tf.nn.relu(net.conv(x, f"Conv_{i}", stride))
        if stride == 1:
            x = tf.nn.max_pool2d(x, 2, 2, "VALID")
    x = tf.nn.relu(net.dense(tf.reduce_mean(x, (1, 2)), "Dense_0"))
    return net.dense(x, "Dense_1")


def _ds_cnn(net: _Net, x):
    tf, arch = net.tf, net.arch
    bn = arch.get("batch_norm", True)
    unit = iter(range(2 * len(arch["filters"])))

    def conv_unit(x, stride=1):
        i = next(unit)
        x = net.conv(x, f"Conv_{i}", stride, bias=not bn)
        return tf.nn.relu(net.batch_norm(x, f"BatchNorm_{i}", 1e-5) if bn else x)

    x = conv_unit(x, arch.get("first_stride", 2))
    pool = arch.get("pool", "avg")
    if pool == "avg":
        x = tf.nn.avg_pool2d(x, 2, 2, "VALID")
    elif pool == "max":
        x = tf.nn.max_pool2d(x, 2, 2, "VALID")
    for _ in arch["filters"][1:]:
        x = conv_unit(conv_unit(x))   # depthwise 3x3, then pointwise 1x1
    return net.dense(tf.reduce_mean(x, (1, 2)), "Dense_0")


def _lstm(net: _Net, xs: list, cell: int, reverse: bool) -> list:
    """flax ``OptimizedLSTMCell_{cell}`` over the steps ``xs`` (each (1, F)),
    from a zero carry, backward when ``reverse``; the outputs in the
    input's order."""
    tf = net.tf
    p = f"p/OptimizedLSTMCell_{cell}"
    w_in = tf.constant(np.concatenate([net.flat[f"{p}/i{g}/kernel"] for g in "ifgo"], 1).astype(np.float32))
    w_h = tf.constant(np.concatenate([net.flat[f"{p}/h{g}/kernel"] for g in "ifgo"], 1).astype(np.float32))
    b = tf.constant(np.concatenate([net.flat[f"{p}/h{g}/bias"] for g in "ifgo"]).astype(np.float32))
    units = int(b.shape[0]) // 4
    h = c = tf.zeros((1, units))
    out = [None] * len(xs)
    for t in (reversed(range(len(xs))) if reverse else range(len(xs))):
        z = tf.matmul(xs[t], w_in) + tf.matmul(h, w_h) + b
        i, f, g, o = tf.split(z, 4, axis=-1)
        c = tf.sigmoid(f) * c + tf.sigmoid(i) * tf.tanh(g)
        h = tf.sigmoid(o) * tf.tanh(c)
        out[t] = h
    return out


def _rnn(net: _Net, x):
    tf = net.tf
    steps = int(x.shape[1])
    xs = [x[:, t, :] for t in range(steps)]
    n = net.arch["n_layers"]
    for layer in range(n):
        fwd = _lstm(net, xs, 2 * layer, False)
        bwd = _lstm(net, xs, 2 * layer + 1, True)
        if layer < n - 1:
            xs = [tf.concat([a, b], -1) for a, b in zip(fwd, bwd)]
    x = tf.concat([fwd[-1], bwd[0]], -1)
    return net.dense(tf.nn.relu(net.dense(x, "Dense_0")), "Dense_1")


def _attention(net: _Net, x, path: str):
    """flax ``MultiHeadDotProductAttention`` at ``path`` as ``attn(x, x)``."""
    tf = net.tf
    length = int(x.shape[1])
    d = int(x.shape[2])

    def heads(name):   # (1, L, d) -> (1, H, L, head_dim)
        kernel = np.asarray(net.flat[f"p/{path}/{name}/kernel"], np.float32)
        h, hd = kernel.shape[1:]
        y = tf.matmul(tf.reshape(x, (length, d)), tf.constant(kernel.reshape(d, h * hd)))
        y = y + tf.constant(np.asarray(net.flat[f"p/{path}/{name}/bias"], np.float32).reshape(h * hd))
        return tf.transpose(tf.reshape(y, (1, length, h, hd)), (0, 2, 1, 3)), h, hd

    q, h, hd = heads("query")
    k, _, _ = heads("key")
    v, _, _ = heads("value")
    weights = tf.nn.softmax(tf.matmul(q / np.float32(np.sqrt(hd)), k, transpose_b=True), -1)
    o = tf.reshape(tf.transpose(tf.matmul(weights, v), (0, 2, 1, 3)), (length, h * hd))
    out = np.asarray(net.flat[f"p/{path}/out/kernel"], np.float32).reshape(h * hd, d)
    return tf.reshape(tf.matmul(o, tf.constant(out)) + net.const(f"p/{path}/out/bias"), (1, length, d))


def _transformer(net: _Net, x):
    tf = net.tf
    n = net.arch["n_blocks"]
    for b in range(n):
        x = net.layer_norm(x + _attention(net, x, f"MultiHeadDotProductAttention_{b}"), f"LayerNorm_{2 * b}")
        ff = net.dense(tf.nn.relu(net.dense(x, f"Dense_{2 * b}")), f"Dense_{2 * b + 1}")
        x = net.layer_norm(x + ff, f"LayerNorm_{2 * b + 1}")
    x = tf.nn.relu(net.dense(tf.reduce_mean(x, 1), f"Dense_{2 * n}"))
    return net.dense(x, f"Dense_{2 * n + 1}")


def resize_matrix(side: int, size: int) -> np.ndarray:
    """(size, side) float32: the bilinear resize of one axis from ``side`` to
    ``size`` positions as ``models.deep.square_resize`` computes it
    (``F.interpolate``, antialiased exactly when it shrinks), read off the
    resize of images whose row i is ones (two columns wide: torch's
    antialiased kernel mishandles an axis of one)."""
    import torch
    import torch.nn.functional as F

    rows = torch.eye(side, dtype=torch.float32)[:, None, :, None].expand(side, 1, side, 2).contiguous()
    cols = F.interpolate(rows, size=(size, 2), mode="bilinear", align_corners=False, antialias=side > size)
    return cols[:, 0, :, 0].T.contiguous().numpy()


def _convbn(net: _Net, x, path: str, stride: int = 1, silu: bool = True):
    """EfficientNet-B0's ``_ConvBN``: a bias-free SAME conv, BatchNorm(1e-3),
    then silu (or nothing: the linear projection)."""
    x = net.batch_norm(net.conv(x, f"{path}/Conv_0", stride, bias=False), f"{path}/BatchNorm_0", 1e-3)
    return x * net.tf.sigmoid(x) if silu else x


def _efficientnet_b0(net: _Net, x, prefix: str):
    """flax ``EfficientNetB0`` (NHWC RGB) -> the pooled (1, 1280) embedding."""
    tf = net.tf
    x = _convbn(net, x, f"{prefix}/_ConvBN_0", 2)
    block, cin = 0, 32
    for t, c, n, s, _k in EFFNET_B0_CONFIG:
        for i in range(n):
            stride, path = s if i == 0 else 1, f"{prefix}/_MBConvSE_{block}"
            h, j = x, 0
            if t != 1:
                h, j = _convbn(net, h, f"{path}/_ConvBN_0"), 1
            h = _convbn(net, h, f"{path}/_ConvBN_{j}", stride)
            se = net.conv(tf.reduce_mean(h, (1, 2), keepdims=True), f"{path}/Conv_0")
            se = net.conv(se * tf.sigmoid(se), f"{path}/Conv_1")
            h = _convbn(net, h * tf.sigmoid(se), f"{path}/_ConvBN_{j + 1}", silu=False)
            x = h + x if stride == 1 and cin == c else h
            block, cin = block + 1, c
    return tf.reduce_mean(_convbn(net, x, f"{prefix}/_ConvBN_1"), (1, 2))


def _teacher(net: _Net, x):
    tf = net.tf
    _, height, width, _ = (int(d) for d in x.shape)
    size = net.arch.get("image_size", 224)
    resize = resize_matrix(max(height, width), size)
    img = tf.matmul(tf.matmul(tf.constant(resize[:, :height]), tf.reshape(x, (height, width))),
                    tf.constant(resize[:, :width].T.copy()))
    img = tf.tile(tf.reshape(img, (1, size, size, 1)), (1, 1, 1, 3))
    return net.dense(_efficientnet_b0(net, img, "backbone"), "head")


_FAMILIES = {"mlp": _mlp, "cnn": _cnn, "distillation_cnn": _cnn, "ds_cnn": _ds_cnn, "rnn": _rnn,
             "transformer": _transformer, "efficientnet_teacher": _teacher}


def concrete_function(arch: dict, flat: dict[str, np.ndarray], norm_mean, norm_var, input_shape: tuple):
    """The bundle's normalised softmax forward as a TF concrete function of
    one float32 input of shape ``(1, *input_shape)``."""
    tf = tensorflow()
    if arch["type"] not in _FAMILIES:
        raise ValueError(f"no TFLite forward for a {arch['type']!r} bundle (deep families: {sorted(_FAMILIES)})")
    if arch["type"] == "efficientnet_teacher":
        from ..models.deep import check_teacher_revision

        check_teacher_revision(arch)
    net = _Net(tf, arch, flat)
    mean = np.asarray(norm_mean, np.float32)
    std = np.sqrt(np.asarray(norm_var, np.float32) + np.float32(1e-6)).astype(np.float32)

    def forward(x):
        return tf.nn.softmax(_FAMILIES[arch["type"]](net, (x - mean) / std), -1)

    spec = tf.TensorSpec((1, *input_shape), tf.float32)
    return tf.function(forward, autograph=False).get_concrete_function(spec)
