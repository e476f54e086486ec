"""step_mfu: the whole scoring step's least operations over the traced
window's time per batch at the float32 peak (TF32 is off, so the tensor
cores' rates do not apply).

Counted from shapes, per clip: the mel power at ``mel_roofline``'s least;
the dB + min-max epilogue at 10 operations a mel value (log, scale,
reference, floor, shift, divide and its four reductions, one each); each
convolution 2 per multiply-add plus its bias, over flax's SAME output
(ceil(size / stride)), a 2x2 pool after each block that does not stride;
the two dense layers 2 per multiply-add plus bias. ReLUs, pools and the
global average are left out.
"""

import math

from benchmark.harness.files import load_module
from benchmark.harness.peaks import F32_PEAK

EPILOGUE_OPS = 10


def cnn_flops(model: dict, height: int, width: int) -> float:
    """FLOP of one clip's CNN forward on a (height, width) feature image."""
    chans = [1, *model["filters"]]
    flops = 0.0
    for i in range(len(model["filters"])):
        stride = model["first_stride"] if i == 0 else model["second_stride"] if i == 1 else 1
        height, width = math.ceil(height / stride), math.ceil(width / stride)
        flops += height * width * chans[i + 1] * (2 * 9 * chans[i] + 1)
        if stride == 1:
            height, width = height // 2, width // 2
    flops += model["dense"] * (2 * chans[-1] + 1) + model["n_classes"] * (2 * model["dense"] + 1)
    return flops


def step_flops(config: dict, mix: dict) -> float:
    """FLOP of one batch of scoring."""
    m = config["features"]["audio_mel_spec"]
    frames = 1 + int(round(mix["clip_seconds"] * m["sample_rate"])) // m["hop_length"]
    mel_flops = load_module("metrics", "mel_roofline").bound(config, mix)[2]
    per_clip = EPILOGUE_OPS * m["n_mels"] * frames + cnn_flops(config["model"], frames, m["n_mels"])
    return mel_flops + int(mix["batch"]) * per_clip


def read(ctx):
    if ctx.trace is None or not ctx.trace_batches:
        return None
    per_batch_s = ctx.trace.window_s / ctx.trace_batches
    return 100.0 * step_flops(ctx.config, ctx.mix) / (per_batch_s * F32_PEAK)
