"""ModelToC: generate a self-contained PlatformIO C project from an .npz
model bundle (mlp / cnn / ds_cnn / distillation_cnn architectures).

The JAX package's ``deploy/codegen.py``, reading bundles through the port's
``optimize.quantize.load_any_bundle`` and the mel tables from the port's
``ops.golden``: for the same bundle the two packages write the same project,
byte for byte. Weights in flash, a ping-pong single-arena forward pass, a
mel frontend bit-matched to the host extractor, PDM/I2S capture with DC
removal and a 4 kHz notch, top-3 serial output, FEAT_DUMP / PCM_DUMP / EVAL
compile-time modes, a per-board platformio.ini and linker script, and a host
harness (host_main.c) so the project compiles with gcc and its numbers can
be held against the port's ``predict_proba`` and mel feature.

fp32 bundles and Stage-6 quantized artifacts share one NHWC/HWIO kernel
library: int8 kernels stay int8 in flash with their scales beside them.
"""

from __future__ import annotations

import json
import logging
import math
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops.golden import librosa_ref as golden
from . import ckernels
from .arena import ArenaEstimator, LayerCost

logger = logging.getLogger(__name__)

BOARDS = {
    "nicla_vision": {
        "platform": "ststm32",
        "board": "nicla_vision",
        "framework": "arduino",
        "audio": "pdm",
        "extra": "board_build.ldscript = nicla_vision.ld",
    },
    "xiao_nrf52840": {
        "platform": "nordicnrf52",
        "board": "xiaoblesense",
        "framework": "arduino",
        "audio": "pdm",
        "extra": "",
    },
    "esp32s3": {
        "platform": "espressif32",
        "board": "esp32-s3-devkitc-1",
        "framework": "arduino",
        "audio": "i2s",
        "extra": "",
    },
    "generic": {
        "platform": "native",
        "board": "",
        "framework": "",
        "audio": "stub",
        "extra": "",
    },
}


def _c_float(v: float) -> str:
    s = f"{v:.9g}"
    if "." not in s and "e" not in s and "n" not in s:  # 0 -> 0.0 (valid f literal)
        s += ".0"
    return s + "f"


def _c_float_array(name: str, arr: np.ndarray, per_line: int = 8) -> str:
    flat = np.asarray(arr, dtype=np.float32).ravel()
    vals = [_c_float(v) for v in flat]
    lines = [", ".join(vals[i : i + per_line]) for i in range(0, len(vals), per_line)]
    body = ",\n    ".join(lines)
    return f"const float {name}[{len(flat)}] = {{\n    {body}\n}};\n"


def _c_int8_array(name: str, arr: np.ndarray, per_line: int = 20) -> str:
    flat = np.asarray(arr, dtype=np.int8).ravel()
    vals = [str(int(v)) for v in flat]
    lines = [", ".join(vals[i : i + per_line]) for i in range(0, len(vals), per_line)]
    body = ",\n    ".join(lines)
    return f"const signed char {name}[{len(flat)}] = {{\n    {body}\n}};\n"


class ModelToC:
    """Generate C sources for one bundle.

    Parameters mirror the reference deploy CLI: labels, feature/frontend
    params (sample_rate, n_mels, n_fft, hop_length, duration), board,
    max_ram_kb budget.
    """

    def __init__(
        self,
        bundle_path: Path | str,
        labels: list[str],
        sample_rate: int = 16000,
        n_mels: int = 40,
        n_fft: int = 512,
        hop_length: int = 160,
        duration: float = 5.0,
        board: str = "nicla_vision",
        max_ram_kb: Optional[float] = 180.0,
    ) -> None:
        from ..optimize.quantize import load_any_bundle

        self.bundle_path = Path(bundle_path)
        # fp32 bundles and Stage-6 quantized artifacts both deploy: int8
        # kernels stay int8 in flash (scale constants beside them); float16
        # artifacts dequantize on load (reference folds DequantizeLinear,
        # onnx_to_c.py:259-274)
        self.arch, self.flat, self.norm_mean, self.norm_var, self.quant_mode, self.qstore = (
            load_any_bundle(self.bundle_path)
        )
        self.labels = list(labels)
        n_classes = int(self.arch.get("n_classes", 0))
        if n_classes and len(self.labels) != n_classes:
            # firmware argmaxes over MODEL_N_CLASSES then prints LABELS[best]
            # — a shorter label list would read past the array on device
            raise ValueError(
                f"{len(self.labels)} label(s) for a {n_classes}-class model "
                f"({self.bundle_path.name}); check --labels/--class-filter "
                "against the training-time class list"
            )
        self.sample_rate = sample_rate
        self.n_mels = n_mels
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.duration = duration
        self.n_samples = int(duration * sample_rate)
        self.n_frames = 1 + self.n_samples // hop_length
        in_shape = self.arch.get("input_shape")
        if in_shape:
            # the generated features_extract writes N_MELS*N_FRAMES floats
            # into the model-input buffer; a mismatched frontend geometry
            # would be an out-of-bounds write on device, so fail generation
            expect = self.n_mels * self.n_frames
            got = int(np.prod(in_shape))
            if got != expect:
                raise ValueError(
                    f"frontend geometry n_mels={n_mels} x n_frames={self.n_frames} "
                    f"(duration={duration}s, hop={hop_length}) produces {expect} "
                    f"values but the model expects input_shape={list(in_shape)} "
                    f"({got}); pass matching --duration/--n-mels/--hop-length"
                )
        if board not in BOARDS:
            raise ValueError(f"Unknown board {board!r}. Supported: {sorted(BOARDS)}")
        self.board = board
        self.max_ram_kb = max_ram_kb
        self.plan = self._build_plan()
        self.arena = ArenaEstimator([LayerCost(p["name"], p["in_shape"], p["out_shape"]) for p in self.plan])

    # ------------------------------------------------------------------
    # Layer plan
    # ------------------------------------------------------------------

    def _param(self, layer: str, kind: str) -> np.ndarray:
        return self.flat[f"p/{layer}/{kind}"]

    def _is_q8(self, layer: str) -> bool:
        return (
            self.quant_mode in ("dynamic_int8", "static_int8")
            and f"p/{layer}/kernel" in self.qstore
        )

    def _build_plan(self) -> list[dict]:
        arch = self.arch
        kind = arch["type"]
        input_shape = tuple(arch["input_shape"])
        plan: list[dict] = []

        def conv(name, layer, hwc, cout, k, stride, padding, dw=False, bn_layer=None):
            """Append a conv (+ optional folded-BN) entry; returns out (H,W,C).
            SAME pads computed here and passed explicitly; VALID = zero pads
            (subsumes the reference's conv_same/conv_valid split)."""
            H, W, C = hwc
            if padding == "same":
                oh, ow = math.ceil(H / stride), math.ceil(W / stride)
                pt = max((oh - 1) * stride + k - H, 0) // 2
                pl = max((ow - 1) * stride + k - W, 0) // 2
            else:  # valid
                oh, ow = (H - k) // stride + 1, (W - k) // stride + 1
                pt = pl = 0
            out_c = C if dw else cout
            plan.append({
                "op": "dwconv2d" if dw else "conv2d", "name": name, "layer": layer,
                "in_shape": (H, W, C), "out_shape": (oh, ow, out_c),
                "k": k, "stride": stride, "pt": pt, "pl": pl,
                "relu": 0 if bn_layer else 1,
                "has_bias": f"p/{layer}/bias" in self.flat,
            })
            if bn_layer:
                plan.append({
                    "op": "batchnorm", "name": f"{name}_bn", "layer": bn_layer,
                    "in_shape": (oh, ow, out_c), "out_shape": (oh, ow, out_c), "relu": 1,
                })
            return oh, ow, out_c

        def pool(name, op, hwc):
            H, W, C = hwc
            plan.append({"op": op, "name": name, "in_shape": (H, W, C), "out_shape": (H // 2, W // 2, C)})
            return H // 2, W // 2, C

        def dense(name, layer, d_in, d_out, act):
            plan.append({
                "op": "dense", "name": name, "layer": layer, "act": act,
                "in_shape": (d_in,), "out_shape": (d_out,),
                "has_bias": f"p/{layer}/bias" in self.flat,
            })

        if kind in ("cnn", "distillation_cnn"):
            if len(input_shape) == 2:
                input_shape = (*input_shape, 1)
            hwc = input_shape
            plan.append({"op": "normalize", "name": "normalize", "in_shape": hwc, "out_shape": hwc})
            for i, f in enumerate(arch["filters"]):
                s = arch.get("first_stride", 1) if i == 0 else (arch.get("second_stride", 1) if i == 1 else 1)
                hwc = conv(f"conv{i}", f"Conv_{i}", hwc, f, 3, s, "same")
                strided = (i == 0 and arch.get("first_stride", 1) > 1) or (
                    i == 1 and arch.get("second_stride", 1) > 1
                )
                if not strided:
                    hwc = pool(f"pool{i}", "maxpool2d", hwc)
            plan.append({"op": "gap2d", "name": "gap", "in_shape": hwc, "out_shape": (hwc[2],)})
            d0 = self._param("Dense_0", "kernel").shape[1]
            dense("dense0", "Dense_0", hwc[2], d0, act=1)
            dense("head", "Dense_1", d0, arch["n_classes"], act=2)
        elif kind == "ds_cnn":
            if len(input_shape) == 2:
                input_shape = (*input_shape, 1)
            hwc = input_shape
            use_bn = arch.get("batch_norm", True)
            plan.append({"op": "normalize", "name": "normalize", "in_shape": hwc, "out_shape": hwc})
            conv_i = 0

            def bn_name():
                return f"BatchNorm_{conv_i}" if use_bn else None

            filters = arch["filters"]
            hwc = conv("stem", f"Conv_{conv_i}", hwc, filters[0], 3,
                       arch.get("first_stride", 2), "same", bn_layer=bn_name())
            conv_i += 1
            pool_kind = arch.get("pool", "avg")
            if pool_kind in ("avg", "max"):
                hwc = pool("pool0", "avgpool2d" if pool_kind == "avg" else "maxpool2d", hwc)
            for b, f in enumerate(filters[1:]):
                hwc = conv(f"dw{b}", f"Conv_{conv_i}", hwc, None, 3, 1, "same",
                           dw=True, bn_layer=bn_name())
                conv_i += 1
                hwc = conv(f"pw{b}", f"Conv_{conv_i}", hwc, f, 1, 1, "valid", bn_layer=bn_name())
                conv_i += 1
            plan.append({"op": "gap2d", "name": "gap", "in_shape": hwc, "out_shape": (hwc[2],)})
            dense("head", "Dense_0", hwc[2], arch["n_classes"], act=2)
        elif kind == "mlp":
            D = int(np.prod(input_shape))
            plan.append({"op": "normalize", "name": "normalize", "in_shape": (D,), "out_shape": (D,)})
            prev = D
            for i, h in enumerate(arch["hidden_units"]):
                dense(f"dense{i}", f"Dense_{i}", prev, h, act=1)
                prev = h
            dense("head", f"Dense_{len(arch['hidden_units'])}", prev, arch["n_classes"], act=2)
        else:
            raise ValueError(
                f"Codegen supports mlp/cnn/distillation_cnn/ds_cnn bundles; got {kind!r} "
                "(sequence models are not deployable to the C runtime, as in the reference)."
            )

        # static-int8 input emulation runs first (the calibrated uint8 grid
        # the Stage-6 accuracy was measured on; _InputQuantWrapper semantics)
        if self.quant_mode == "static_int8" and arch.get("input_range"):
            lo, hi = (float(v) for v in arch["input_range"])
            first = plan[0]["in_shape"]
            plan.insert(0, {
                "op": "quant_dequant", "name": "in_q", "in_shape": first, "out_shape": first,
                "lo": lo, "scale": max((hi - lo) / 255.0, 1e-12),
            })
        return plan

    # ------------------------------------------------------------------
    # File generation
    # ------------------------------------------------------------------

    def generate(self, out_dir: Path | str) -> Path:
        out_dir = Path(out_dir)
        src = out_dir / "src"
        src.mkdir(parents=True, exist_ok=True)
        if self.max_ram_kb is not None:
            self.arena.check_max_ram(self.max_ram_kb)
        logger.info("Arena plan:\n%s", self.arena.table())

        (src / "ml_kernels.h").write_text(ckernels.ML_KERNELS_H)
        (src / "ml_kernels.c").write_text(ckernels.ML_KERNELS_C)
        (src / "frontend.h").write_text(ckernels.FEATURES_H)
        (src / "frontend.c").write_text(
            ckernels.FEATURES_C_TEMPLATE.format(
                n_fft=self.n_fft, hop=self.hop_length, n_mels=self.n_mels,
                n_frames=self.n_frames, n_samples=self.n_samples,
            )
        )
        (src / "feat_data.h").write_text(self._gen_feat_data_h())
        (src / "feat_data.c").write_text(self._gen_feat_data_c())
        (src / "weights.h").write_text(self._gen_weights_h())
        (src / "weights.c").write_text(self._gen_weights_c())
        (src / "model.h").write_text(self._gen_model_h())
        (src / "model.c").write_text(self._gen_model_c())
        (src / "labels.h").write_text(self._gen_labels_h())
        from .firmware import AUDIO_H, AUDIO_I2S_CPP, AUDIO_PDM_CPP, AUDIO_STUB_CPP, NICLA_LD

        (src / "main.cpp").write_text(self._gen_main_cpp())
        (src / "audio.h").write_text(AUDIO_H)
        audio_kind = BOARDS[self.board]["audio"]
        (src / "audio.cpp").write_text({"pdm": AUDIO_PDM_CPP, "i2s": AUDIO_I2S_CPP, "stub": AUDIO_STUB_CPP}[audio_kind])
        (out_dir / "host_main.c").write_text(ckernels.HOST_MAIN_C)
        (out_dir / "platformio.ini").write_text(self._gen_platformio_ini())
        if self.board == "nicla_vision":
            (out_dir / "nicla_vision.ld").write_text(NICLA_LD)
        (out_dir / "codegen_report.json").write_text(
            json.dumps(
                {
                    "bundle": str(self.bundle_path),
                    "arch": self.arch["type"],
                    "quantization": self.quant_mode,
                    "board": self.board,
                    "labels": self.labels,
                    "arena_peak_kb": self.arena.peak_bytes / 1024,
                    "arena_buffer_kb": self.arena.buffer_bytes / 1024,
                    "frontend": {
                        "sample_rate": self.sample_rate, "n_mels": self.n_mels,
                        "n_fft": self.n_fft, "hop_length": self.hop_length,
                        "duration": self.duration, "n_frames": self.n_frames,
                    },
                },
                indent=2,
            )
        )
        logger.info("Generated C project -> %s", out_dir)
        return out_dir

    # -- headers / data ---------------------------------------------------

    def _gen_feat_data_h(self) -> str:
        return (
            "#ifndef FEAT_DATA_H\n#define FEAT_DATA_H\n\n"
            f"extern const float feat_hann[{self.n_fft}];\n"
            f"extern const float feat_mel_fb[{self.n_mels * (self.n_fft // 2 + 1)}];\n\n"
            "#endif\n"
        )

    def _gen_feat_data_c(self) -> str:
        hann = golden.hann_periodic(self.n_fft)
        fb = golden.mel_filterbank(self.sample_rate, self.n_fft, self.n_mels)
        return (
            '#include "feat_data.h"\n\n'
            "/* periodic Hann window + slaney mel filterbank (librosa contract;\n"
            " * generated from ops.golden — the same constants the JAX path uses) */\n"
            + _c_float_array("feat_hann", hann)
            + "\n"
            + _c_float_array("feat_mel_fb", fb)
        )

    _BN_EPS = 1e-5  # flax nn.BatchNorm epsilon (models/deep.py DSCNNModule)

    def _weight_tensors(self) -> list[dict]:
        """Flash-resident tensors as {name, arr, ctype: 'f32'|'q8', scale}.
        int8-mode kernels keep their quantized bytes + per-tensor scale;
        biases and BN affines are always float (dequantized on load)."""
        tensors: list[dict] = []

        def add(name, arr, layer_kernel_key=None):
            if layer_kernel_key is not None and layer_kernel_key in self.qstore and \
                    self.quant_mode in ("dynamic_int8", "static_int8"):
                q, scale = self.qstore[layer_kernel_key]
                tensors.append({"name": name, "arr": q, "ctype": "q8", "scale": scale})
            else:
                tensors.append({"name": name, "arr": arr, "ctype": "f32"})

        for p in self.plan:
            if p["op"] in ("conv2d", "dwconv2d", "dense"):
                add(f"wt_{p['name']}_k", self._param(p["layer"], "kernel"),
                    layer_kernel_key=f"p/{p['layer']}/kernel")
                if p.get("has_bias"):
                    add(f"wt_{p['name']}_b", self._param(p["layer"], "bias"))
            elif p["op"] == "batchnorm":
                L = p["layer"]
                gamma, beta = self._param(L, "scale"), self._param(L, "bias")
                mu = self.flat[f"c/batch_stats/{L}/mean"]
                var = self.flat[f"c/batch_stats/{L}/var"]
                bn_scale = gamma / np.sqrt(var + self._BN_EPS)
                add(f"wt_{p['name']}_scale", bn_scale)
                add(f"wt_{p['name']}_shift", beta - mu * bn_scale)
        norm_mean = np.asarray(self.norm_mean).ravel()
        inv_std = 1.0 / np.sqrt(np.asarray(self.norm_var).ravel() + 1e-6)
        add("wt_norm_mean", norm_mean)
        add("wt_norm_inv_std", inv_std)
        return tensors

    def _gen_weights_h(self) -> str:
        lines = ["#ifndef WEIGHTS_H", "#define WEIGHTS_H", ""]
        for t in self._weight_tensors():
            if t["ctype"] == "q8":
                lines.append(f"extern const signed char {t['name']}[{np.asarray(t['arr']).size}];")
                lines.append(f"extern const float {t['name']}_scale;")
            else:
                lines.append(f"extern const float {t['name']}[{np.asarray(t['arr']).size}];")
        lines += ["", "#endif", ""]
        return "\n".join(lines)

    def _gen_weights_c(self) -> str:
        parts = ['#include "weights.h"\n\n/* model weights in flash (HWIO conv layout) */\n']
        for t in self._weight_tensors():
            if t["ctype"] == "q8":
                parts.append(_c_int8_array(t["name"], t["arr"]))
                parts.append(f"const float {t['name']}_scale = {_c_float(t['scale'])};\n")
            else:
                parts.append(_c_float_array(t["name"], t["arr"]))
        return "\n".join(parts)

    def _gen_labels_h(self) -> str:
        quoted = ",\n    ".join(f'"{l}"' for l in self.labels)
        return (
            "#ifndef LABELS_H\n#define LABELS_H\n\n"
            f"#define N_LABELS {len(self.labels)}\n"
            f"static const char *LABELS[N_LABELS] = {{\n    {quoted}\n}};\n\n#endif\n"
        )

    # -- model ------------------------------------------------------------

    def _gen_model_h(self) -> str:
        in_size = int(np.prod(self.plan[0]["in_shape"]))
        arena_floats = self.arena.buffer_bytes // 4 * 2  # two ping-pong halves
        return (
            "#ifndef MODEL_H\n#define MODEL_H\n\n#include <stddef.h>\n\n"
            f"#define MODEL_INPUT_SIZE {in_size}\n"
            f"#define MODEL_N_CLASSES {self.arch['n_classes']}\n"
            f"#define MODEL_ARENA_FLOATS {arena_floats}\n"
            f"#define MODEL_N_SAMPLES {self.n_samples}\n"
            f"#define MODEL_N_MELS {self.n_mels}\n"
            f"#define MODEL_N_FRAMES {self.n_frames}\n\n"
            "void model_run(const float *input, float *scores, float *arena);\n\n#endif\n"
        )

    def _gen_model_c(self) -> str:
        half = self.arena.buffer_bytes // 4
        lines = [
            '#include "model.h"',
            '#include "ml_kernels.h"',
            '#include "weights.h"',
            "#include <string.h>",
            "",
            "/* ping-pong forward pass over a single caller-provided arena */",
            "void model_run(const float *input, float *scores, float *arena) {",
            f"    float *buf_a = arena;",
            f"    float *buf_b = arena + {half};",
            "    const float *cur = input;",
            "    float *nxt = buf_a;",
        ]
        for p in self.plan:
            in_shape, out_shape = p["in_shape"], p["out_shape"]
            name = p["name"]
            q8 = p["op"] in ("conv2d", "dwconv2d", "dense") and self._is_q8(p.get("layer", ""))
            bias = f"wt_{name}_b" if p.get("has_bias") else "0"
            if p["op"] == "normalize":
                c = in_shape[-1]
                n = int(np.prod(in_shape))
                lines.append(f"    ml_normalize(cur, nxt, {n}, wt_norm_mean, wt_norm_inv_std, {c});")
            elif p["op"] == "quant_dequant":
                n = int(np.prod(in_shape))
                lines.append(
                    f"    ml_quant_dequant(cur, nxt, {n}, {_c_float(p['lo'])}, {_c_float(p['scale'])});"
                )
            elif p["op"] == "conv2d":
                h, w, cin = in_shape
                oh, ow, cout = out_shape
                k, s = p["k"], p["stride"]
                geom = f"{h}, {w}, {cin}, {cout}, {k}, {k}, {s}, {s}, {p['pt']}, {p['pl']}, {oh}, {ow}, {p['relu']}"
                if q8:
                    lines.append(f"    ml_conv2d_q8(cur, nxt, wt_{name}_k, wt_{name}_k_scale, {bias}, {geom});")
                else:
                    lines.append(f"    ml_conv2d(cur, nxt, wt_{name}_k, {bias}, {geom});")
            elif p["op"] == "dwconv2d":
                h, w, c = in_shape
                oh, ow, _ = out_shape
                k, s = p["k"], p["stride"]
                geom = f"{h}, {w}, {c}, {k}, {k}, {s}, {s}, {p['pt']}, {p['pl']}, {oh}, {ow}, {p['relu']}"
                if q8:
                    lines.append(f"    ml_dwconv2d_q8(cur, nxt, wt_{name}_k, wt_{name}_k_scale, {bias}, {geom});")
                else:
                    lines.append(f"    ml_dwconv2d(cur, nxt, wt_{name}_k, {bias}, {geom});")
            elif p["op"] == "batchnorm":
                h, w, c = in_shape
                lines.append(
                    f"    ml_batchnorm(cur, nxt, {h * w}, {c}, wt_{name}_scale, wt_{name}_shift, {p['relu']});"
                )
            elif p["op"] == "maxpool2d":
                h, w, c = in_shape
                oh, ow, _ = out_shape
                lines.append(f"    ml_maxpool2d(cur, nxt, {h}, {w}, {c}, 2, 2, 2, 2, {oh}, {ow});")
            elif p["op"] == "avgpool2d":
                h, w, c = in_shape
                oh, ow, _ = out_shape
                lines.append(f"    ml_avgpool2d(cur, nxt, {h}, {w}, {c}, 2, 2, 2, 2, {oh}, {ow});")
            elif p["op"] == "gap2d":
                h, w, c = in_shape
                lines.append(f"    ml_gap2d(cur, nxt, {h}, {w}, {c});")
            elif p["op"] == "dense":
                (i_dim,), (o_dim,) = in_shape, out_shape
                is_last = p is self.plan[-1]
                dst = "scores" if is_last else "nxt"
                if q8:
                    lines.append(
                        f"    ml_dense_q8(cur, {dst}, wt_{name}_k, wt_{name}_k_scale, {bias}, "
                        f"{i_dim}, {o_dim}, {p['act']});"
                    )
                else:
                    lines.append(f"    ml_dense(cur, {dst}, wt_{name}_k, {bias}, {i_dim}, {o_dim}, {p['act']});")
                if is_last:
                    lines.append("    return;")
                    continue
            lines.append("    cur = nxt; nxt = (nxt == buf_a) ? buf_b : buf_a;")
        lines += ["}", ""]
        return "\n".join(lines)

    # -- firmware ----------------------------------------------------------

    def _gen_main_cpp(self) -> str:
        from .firmware import MAIN_CPP_TEMPLATE

        b0, b1, b2, a1, a2 = _notch_coeffs(self.sample_rate)
        return MAIN_CPP_TEMPLATE.format(
            sample_rate=self.sample_rate,
            n_samples=self.n_samples,
            b0=f"{b0:.9g}", b1=f"{b1:.9g}", b2=f"{b2:.9g}", a1=f"{a1:.9g}", a2=f"{a2:.9g}",
        )

    def _gen_platformio_ini(self) -> str:
        spec = BOARDS[self.board]
        if self.board == "generic":
            return (
                "[env:host]\nplatform = native\nbuild_flags = -O2 -lm\n"
                "; host-only build: compile host_main.c + src/*.c with gcc\n"
            )
        return (
            f"[env:{self.board}]\n"
            f"platform = {spec['platform']}\n"
            f"board = {spec['board']}\n"
            f"framework = {spec['framework']}\n"
            "build_flags = -O2\n"
            "monitor_speed = 115200\n"
            f"{spec['extra']}\n"
        )


def _notch_coeffs(sr: float, freq: float = 4000.0, q: float = 8.0):
    """RBJ biquad notch (kills the PDM clock artifact at 4 kHz;
    reference model_to_c.py:742-759)."""
    w0 = 2 * math.pi * freq / sr
    alpha = math.sin(w0) / (2 * q)
    b0, b1, b2 = 1.0, -2 * math.cos(w0), 1.0
    a0, a1, a2 = 1 + alpha, -2 * math.cos(w0), 1 - alpha
    return b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0
