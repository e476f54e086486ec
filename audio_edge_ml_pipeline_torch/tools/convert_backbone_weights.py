"""Convert pretrained MobileNetV2 / EfficientNet-B0 weights into the
named-key ``.npz`` layout (``p/<path>`` params + ``c/batch_stats/<path>``
running statistics, flax's names) that ``models.backbones.
load_backbone_weights`` reads, or (with ``--prefix backbone --bundle``) a
trainer bundle that warm-starts ``efficientnet_teacher`` through
``--param pretrained_model=<out.npz>``.

Counterpart of the repository's ``tools/convert_backbone_weights.py``, with
its flags and its output, array for array. The shape template comes from
the port's own ``models/backbones.py`` modules (their state_dicts in the
flax layout), so it needs only torch and numpy; the Keras sources import
TensorFlow when they are read.

Sources:
  - a Keras MobileNetV2 / EfficientNetB0 saved model (``.keras`` / ``.h5``,
    ``keras.applications``' layer names), mapped BY LAYER NAME
    (Conv1/bn_Conv1, expanded_conv_*, block_{i}_{expand,depthwise,project}
    [_BN], Conv_1; stem_conv/stem_bn, block{stage}{rep}_{expand_conv,dwconv,
    se_reduce,se_expand,project_conv}[+ _bn], top_conv/top_bn);
  - a torchvision ``mobilenet_v2`` state_dict saved with ``torch.save``
    (classifier head and ``num_batches_tracked`` entries dropped);
  - any ``.npz`` whose arrays appear in the same tensor order (arr_0, ...).

The positional sources pair tensors in MODULE-EXECUTION order (stem conv ->
inverted-residual blocks per the paper table -> head conv; within each
conv-bn unit: conv weight, bn gamma, bn beta, running mean, running var),
with a shape check per tensor. Conv kernels are transposed OIHW -> HWIO
(depthwise (C, 1, kh, kw) -> (kh, kw, 1, C) falls out of the same
transpose).

Usage:
    python -m audio_edge_ml_pipeline_torch.tools.convert_backbone_weights \
        --src mobilenet_v2.pth --out mbv2_imagenet.npz [--input-size 224] \
        [--arch mobilenet_v2|efficientnet_b0] [--prefix backbone --bundle]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..models.backbones import EFFNET_B0_CONFIG, MBV2_CONFIG


def mbv2_flax_key_order() -> list[str]:
    """Named-npz keys in module-execution order (5 tensors per conv-bn unit,
    matching the torch state_dict tensor sequence)."""
    units = ["_ConvBN_0"]  # stem
    block = 0
    for t, _c, n, _s in MBV2_CONFIG:
        for _ in range(n):
            n_units = 2 if t == 1 else 3  # expand / depthwise / project
            units += [f"_InvertedResidual_{block}/_ConvBN_{j}" for j in range(n_units)]
            block += 1
    units.append("_ConvBN_1")  # head 1x1 conv
    keys = []
    for u in units:
        keys += _convbn_keys(u)
    return keys


def keras_mbv2_layer_map() -> list[tuple[str, str, str]]:
    """(keras conv layer, keras bn layer, flax unit path) in execution order,
    in keras.applications.MobileNetV2's layer naming (Conv1/bn_Conv1,
    expanded_conv_* for block 0, block_{i}_* for 1..16, Conv_1/Conv_1_bn
    head)."""
    pairs = [("Conv1", "bn_Conv1", "_ConvBN_0")]
    block = 0
    for t, _c, n, _s in MBV2_CONFIG:
        for _ in range(n):
            prefix = "expanded_conv" if block == 0 else f"block_{block}"
            unit = f"_InvertedResidual_{block}/_ConvBN_{{}}"
            j = 0
            if t != 1:
                pairs.append((f"{prefix}_expand", f"{prefix}_expand_BN", unit.format(0)))
                j = 1
            pairs.append((f"{prefix}_depthwise", f"{prefix}_depthwise_BN", unit.format(j)))
            pairs.append((f"{prefix}_project", f"{prefix}_project_BN", unit.format(j + 1)))
            block += 1
    pairs.append(("Conv_1", "Conv_1_bn", "_ConvBN_1"))
    return pairs


def backbone_template(arch: str) -> dict[str, tuple]:
    """flax key -> shape of every tensor of the port's ``arch`` backbone
    (``mobilenet_v2`` or ``efficientnet_b0``)."""
    from ..models.backbones import EfficientNetB0, MobileNetV2
    from ..models.deep import params_to_flax

    module = EfficientNetB0() if arch == "efficientnet_b0" else MobileNetV2()
    return {k: v.shape for k, v in params_to_flax(module.state_dict()).items()}


def convert_keras_mobilenet_v2(model, template: dict[str, tuple]) -> dict[str, np.ndarray]:
    """Map a keras.applications.MobileNetV2 instance to the named-npz layout
    BY LAYER NAME (no positional assumptions). Keras Conv2D kernels are
    already HWIO; DepthwiseConv2D (kh, kw, C, 1) -> flax grouped-conv
    (kh, kw, 1, C); BN weights arrive [gamma, beta, moving_mean,
    moving_var]."""
    out: dict[str, np.ndarray] = {}
    for conv_name, bn_name, unit in keras_mbv2_layer_map():
        out.update(_take_convbn(model, conv_name, bn_name, unit))
    return _checked_against_template(out, template)


def _checked_against_template(out: dict[str, np.ndarray], template: dict[str, tuple]) -> dict[str, np.ndarray]:
    """Per-tensor shape check + completeness check shared by both Keras
    converters; returns the dict with contiguous float32 arrays."""
    for key, arr in out.items():
        want = tuple(template[key])
        if tuple(arr.shape) != want:
            raise ValueError(f"{key}: keras source shape {arr.shape} != model shape {want}")
        out[key] = np.ascontiguousarray(arr)
    missing = set(template) - set(out)
    if missing:
        raise ValueError(f"{len(missing)} model tensors unmapped, e.g. {sorted(missing)[:3]}")
    return out


def _convbn_keys(unit: str) -> list[str]:
    return [
        f"p/{unit}/Conv_0/kernel",
        f"p/{unit}/BatchNorm_0/scale",
        f"p/{unit}/BatchNorm_0/bias",
        f"c/batch_stats/{unit}/BatchNorm_0/mean",
        f"c/batch_stats/{unit}/BatchNorm_0/var",
    ]


def _take_convbn(model, conv_name: str, bn_name: str, unit: str) -> dict[str, np.ndarray]:
    kernel = np.asarray(model.get_layer(conv_name).get_weights()[0], np.float32)
    if "dwconv" in conv_name or conv_name.endswith("depthwise"):
        kernel = np.transpose(kernel, (0, 1, 3, 2))  # (kh,kw,C,1) -> (kh,kw,1,C)
    gamma, beta, mean, var = (np.asarray(w, np.float32) for w in model.get_layer(bn_name).get_weights())
    return dict(zip(_convbn_keys(unit), [kernel, gamma, beta, mean, var]))


def convert_keras_efficientnet_b0(model, template: dict[str, tuple]) -> dict[str, np.ndarray]:
    """Map a keras.applications.EfficientNetB0 BY LAYER NAME onto the
    EfficientNetB0 key layout. The model's input-side ``rescaling`` /
    ``normalization`` layers are preprocessing, not backbone weights: with a
    real ImageNet checkpoint, feed the backbone ``x / 255`` normalized by
    the checkpoint's normalization constants."""
    out = dict(_take_convbn(model, "stem_conv", "stem_bn", "_ConvBN_0"))
    unit_idx = 0
    for stage, (t, _c, n, _s, _k) in enumerate(EFFNET_B0_CONFIG, start=1):
        for rep in range(n):
            kb = f"block{stage}{chr(ord('a') + rep)}"
            fb = f"_MBConvSE_{unit_idx}"
            j = 0
            if t != 1:
                out.update(_take_convbn(model, f"{kb}_expand_conv", f"{kb}_expand_bn", f"{fb}/_ConvBN_0"))
                j = 1
            out.update(_take_convbn(model, f"{kb}_dwconv", f"{kb}_bn", f"{fb}/_ConvBN_{j}"))
            for se_i, se_name in enumerate(("se_reduce", "se_expand")):
                k_w, k_b = model.get_layer(f"{kb}_{se_name}").get_weights()
                out[f"p/{fb}/Conv_{se_i}/kernel"] = np.asarray(k_w, np.float32)
                out[f"p/{fb}/Conv_{se_i}/bias"] = np.asarray(k_b, np.float32)
            out.update(_take_convbn(model, f"{kb}_project_conv", f"{kb}_project_bn", f"{fb}/_ConvBN_{j + 1}"))
            unit_idx += 1
    out.update(_take_convbn(model, "top_conv", "top_bn", "_ConvBN_1"))
    return _checked_against_template(out, template)


def _source_tensors(src: Path) -> list[np.ndarray]:
    src = Path(src)
    if src.suffix == ".npz":
        data = np.load(src, allow_pickle=False)
        return [data[k] for k in data.files]
    import torch

    state = torch.load(src, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    out = []
    for name, tensor in state.items():
        if "num_batches_tracked" in name or name.startswith("classifier"):
            continue
        out.append(np.asarray(tensor.detach().cpu().numpy()))
    return out


def convert_mobilenet_v2(tensors: list[np.ndarray], template: dict[str, tuple]) -> dict[str, np.ndarray]:
    """Pair source tensors with flax keys positionally; returns the named
    dict ready for np.savez. ``template`` maps key -> expected shape."""
    keys = mbv2_flax_key_order()
    if len(tensors) != len(keys):
        raise ValueError(
            f"source has {len(tensors)} tensors but MobileNetV2 needs {len(keys)} "
            "(is this a torchvision mobilenet_v2 state_dict without the classifier?)"
        )
    out = {}
    for key, arr in zip(keys, tensors):
        if key.endswith("/kernel"):
            arr = np.transpose(arr, (2, 3, 1, 0))  # OIHW -> HWIO (dw falls out too)
        want = tuple(template[key])
        if tuple(arr.shape) != want:
            raise ValueError(f"{key}: source shape {arr.shape} != model shape {want}")
        out[key] = np.ascontiguousarray(arr, dtype=np.float32)
    return out


def with_prefix(named: dict[str, np.ndarray], prefix: str) -> dict[str, np.ndarray]:
    """Every key moved under ``prefix``/ inside ``p/`` and ``c/<collection>/``."""
    pre = prefix.strip("/")
    renamed = {}
    for k, v in named.items():
        col, _, rest = k.partition("/")
        if col == "p":
            renamed[f"p/{pre}/{rest}"] = v
        else:  # c/<collection>/<path>
            coll, _, path = rest.partition("/")
            renamed[f"c/{coll}/{pre}/{path}"] = v
    return renamed


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m audio_edge_ml_pipeline_torch.tools.convert_backbone_weights",
                                description=__doc__.splitlines()[0])
    p.add_argument("--src", required=True,
                   help="Keras saved model (.keras/.h5), torch state_dict (.pt/.pth), or ordered .npz")
    p.add_argument("--out", required=True, help="output named-key .npz")
    p.add_argument("--arch", choices=("mobilenet_v2", "efficientnet_b0"), default="mobilenet_v2",
                   help="target backbone (efficientnet_b0 requires a Keras source)")
    p.add_argument("--input-size", type=int, default=224,
                   help="the image side the weights are for (no tensor's shape depends on it)")
    p.add_argument("--prefix", default=None, metavar="PATH",
                   help="prepend PATH/ inside p/ and c/<col>/ keys — e.g. 'backbone' "
                        "to match EfficientNetTeacherModule's submodule name")
    p.add_argument("--bundle", action="store_true",
                   help="write a trainer-consumable bundle (__meta__ + identity norm "
                        "stats) so --param pretrained_model=<out.npz> warm-starts a "
                        "trainer directly")
    args = p.parse_args(argv)

    template = backbone_template(args.arch)
    src = Path(args.src)
    if src.suffix in (".keras", ".h5"):
        from ..compilation.tf_forward import tensorflow

        keras_model = tensorflow().keras.models.load_model(src, compile=False)
        if args.arch == "efficientnet_b0":
            named = convert_keras_efficientnet_b0(keras_model, template)
        else:
            named = convert_keras_mobilenet_v2(keras_model, template)
    elif args.arch == "efficientnet_b0":
        raise SystemExit("--arch efficientnet_b0 needs a Keras .keras/.h5 source")
    else:
        named = convert_mobilenet_v2(_source_tensors(src), template)
    if args.prefix:
        named = with_prefix(named, args.prefix)
    if args.bundle:
        # the bundle layout's one writer, so that a converted file loads as every bundle does
        from ..models.deep import save_model_bundle_flat

        meta = {"type": f"{args.arch}_backbone", "source": src.name}
        if args.arch == "efficientnet_b0":
            meta["act"] = "silu"  # arch revision marker (models.deep.check_teacher_revision)
        save_model_bundle_flat(Path(args.out), meta, named, np.zeros(1, np.float32), np.ones(1, np.float32))
    else:
        np.savez(args.out, **named)
    print(f"wrote {len(named)} tensors -> {args.out}")


if __name__ == "__main__":
    main()
