"""Convert a .tflite flatbuffer into an alignas(8) C byte-array header for
firmware that embeds the TFLite Micro interpreter (the JAX package's
``compilation/generate_c_header.py``; the header is the same byte for byte).

CLI: python -m audio_edge_ml_pipeline_torch.compilation.generate_c_header \
        --model deploy/model.tflite [--output model_data.h] [--name g_model]
"""

from __future__ import annotations

import argparse
from pathlib import Path


def generate_header(model_path: Path, output_path: Path, array_name: str = "g_model") -> Path:
    blob = Path(model_path).read_bytes()
    guard = output_path.name.upper().replace(".", "_").replace("-", "_")
    lines = [
        f"/* Generated from {Path(model_path).name} — do not edit. */",
        f"#ifndef {guard}",
        f"#define {guard}",
        "",
        "#include <stddef.h>",
        "",
        f"alignas(8) const unsigned char {array_name}[] = {{",
    ]
    for i in range(0, len(blob), 12):
        chunk = ", ".join(f"0x{b:02x}" for b in blob[i : i + 12])
        lines.append(f"    {chunk},")
    lines += [
        "};",
        f"const size_t {array_name}_len = {len(blob)};",
        "",
        "#endif",
        "",
    ]
    output_path.write_text("\n".join(lines))
    return output_path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="python -m audio_edge_ml_pipeline_torch.compilation.generate_c_header")
    p.add_argument("--model", required=True)
    p.add_argument("--output", default=None)
    p.add_argument("--name", default="g_model")
    args = p.parse_args(argv)
    out = Path(args.output or Path(args.model).with_suffix("").name + "_data.h")
    generate_header(Path(args.model), out, args.name)
    print(f"{out}  ({Path(args.model).stat().st_size} bytes embedded)")


if __name__ == "__main__":
    main()
