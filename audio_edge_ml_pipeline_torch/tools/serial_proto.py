"""Shared serial protocol for the device tools (the port's copy of the
repository's ``tools/serial_proto.py``, byte for byte the same frames).

Framing and text protocols match the generated firmware (deploy/firmware.py):
  - magic-framed binary blocks:
        FEAT  FE ED 12 34 | u32 n_mels, u32 n_frames | f32 payload | DE AD 56 78
        PCM   CA FE BA BE | u32 n_samples            | i16 payload | DE AD 56 78
  - EVAL text protocol: host sends 'R'; device replies
        PRED <label>\\nSCORES <p0> <p1> ...\\nEVAL_DONE

pyserial is optional: every tool accepts any object with read/write/timeout
(tests inject a loopback transport; on hardware pass a serial.Serial).
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

MAGIC_FEAT = bytes([0xFE, 0xED, 0x12, 0x34])
MAGIC_PCM = bytes([0xCA, 0xFE, 0xBA, 0xBE])
MAGIC_END = bytes([0xDE, 0xAD, 0x56, 0x78])


def autodetect_port() -> str:
    """First USB-serial device (reference tools default: auto-detect when
    --port is omitted). Checks Linux ttyACM/ttyUSB then macOS cu.usbmodem."""
    import glob

    for pat in ("/dev/ttyACM*", "/dev/ttyUSB*", "/dev/cu.usbmodem*"):
        hits = sorted(glob.glob(pat))
        if hits:
            return hits[0]
    raise SystemExit("no serial device found — pass --port explicitly")


def open_serial(port: str, baud: int = 115200, timeout: float = 5.0):
    """Open a pyserial port (clear error when pyserial is unavailable)."""
    try:
        import serial
    except ImportError as exc:
        raise SystemExit(
            "pyserial is not installed in this environment. Install it on the "
            "host machine connected to the device, or pass a transport object "
            "programmatically."
        ) from exc
    return serial.Serial(port, baud, timeout=timeout)


def _read_exact(ser, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = ser.read(n - len(buf))
        if not chunk:
            raise TimeoutError(f"serial read timed out ({len(buf)}/{n} bytes)")
        buf += chunk
    return buf


def _sync_to(ser, magic: bytes, max_bytes: int = 1 << 20) -> None:
    window = b""
    for _ in range(max_bytes):
        b = ser.read(1)
        if not b:
            raise TimeoutError(f"no magic {magic.hex()} found")
        window = (window + b)[-4:]
        if window == magic:
            return
    raise TimeoutError("sync window exceeded")


def read_feat_frame(ser) -> np.ndarray:
    """Blocking read of one FEAT frame -> (n_mels, n_frames) float32."""
    _sync_to(ser, MAGIC_FEAT)
    n_mels, n_frames = struct.unpack("<II", _read_exact(ser, 8))
    payload = _read_exact(ser, n_mels * n_frames * 4)
    if _read_exact(ser, 4) != MAGIC_END:
        raise IOError("FEAT frame missing end magic")
    return np.frombuffer(payload, dtype="<f4").reshape(n_mels, n_frames).copy()


def read_pcm_frame(ser) -> np.ndarray:
    """Blocking read of one PCM frame -> (n,) int16."""
    _sync_to(ser, MAGIC_PCM)
    (n,) = struct.unpack("<I", _read_exact(ser, 4))
    payload = _read_exact(ser, n * 2)
    if _read_exact(ser, 4) != MAGIC_END:
        raise IOError("PCM frame missing end magic")
    return np.frombuffer(payload, dtype="<i2").copy()


def write_feat_frame(ser, feat: np.ndarray) -> None:
    """Device-side encoding (used by the loopback transport in tests)."""
    feat = np.asarray(feat, dtype="<f4")
    ser.write(MAGIC_FEAT)
    ser.write(struct.pack("<II", feat.shape[0], feat.shape[1]))
    ser.write(feat.tobytes())
    ser.write(MAGIC_END)


def write_pcm_frame(ser, pcm: np.ndarray) -> None:
    pcm = np.asarray(pcm, dtype="<i2")
    ser.write(MAGIC_PCM)
    ser.write(struct.pack("<I", len(pcm)))
    ser.write(pcm.tobytes())
    ser.write(MAGIC_END)


def read_line(ser) -> str:
    out = b""
    while not out.endswith(b"\n"):
        b = ser.read(1)
        if not b:
            raise TimeoutError("serial line read timed out")
        out += b
    return out.decode("utf-8", "replace").strip()


def eval_roundtrip(ser) -> tuple[str, np.ndarray]:
    """Send 'R', parse PRED/SCORES/EVAL_DONE. Returns (label, scores)."""
    ser.write(b"R")
    pred: Optional[str] = None
    scores: Optional[np.ndarray] = None
    while True:
        line = read_line(ser)
        if line.startswith("PRED "):
            pred = line[5:].strip()
        elif line.startswith("SCORES"):
            scores = np.array([float(x) for x in line.split()[1:]], dtype=np.float32)
        elif line == "EVAL_DONE":
            break
    if pred is None or scores is None:
        raise IOError("incomplete EVAL reply")
    return pred, scores


class LoopbackSerial:
    """In-memory transport: what tools write lands in a device-side buffer,
    and a device callback queues reply bytes. Used by tests and the
    device-free simulator mode of the tools."""

    def __init__(self, on_write=None):
        self._rx = bytearray()  # bytes waiting for the host to read
        self._on_write = on_write

    def read(self, n: int = 1) -> bytes:
        out = bytes(self._rx[:n])
        del self._rx[:n]
        return out

    def write(self, data: bytes) -> int:
        if self._on_write:
            self._on_write(self, data)
        else:
            self._rx.extend(data)  # true loopback: written bytes are readable
        return len(data)

    def feed(self, data: bytes) -> None:
        self._rx.extend(data)
