"""MicroPython/ulab on-device SVM runtime (shipped with the export_svm
bundle). Alternative device path to the C firmware: record -> MFCC via ulab
FFT -> scaler -> PCA -> linear one-vs-one SVM vote -> LED state machine
(capability of reference nicla_main.py:1-398)."""

NICLA_MAIN_PY = '''\
# nicla_main.py — MicroPython/ulab audio classifier (pca_svm bundle runtime)
#
# Copy this file together with the bundle .npy files to the board's flash.
# Pipeline: PDM record -> framed |FFT|^2 -> mel filterbank -> log -> DCT-II
# (MFCC) -> mean over frames -> StandardScaler -> PCA -> linear OvO SVM vote.
#
# LED state machine: blue=listening, green=confident prediction,
# red=low confidence / error.

import json
import time

from ulab import numpy as np

try:
    import audio  # OpenMV / Nicla audio module
    import pyb
    HAS_HW = True
except ImportError:
    HAS_HW = False

BUNDLE = "./"


def _load(name):
    return np.load(BUNDLE + name)


PARAMS = json.load(open(BUNDLE + "feature_params.json"))
LABELS = json.load(open(BUNDLE + "label_names.json"))
SCALER_MEAN = _load("scaler_mean.npy")
SCALER_SCALE = _load("scaler_scale.npy")
PCA_COMP = _load("pca_components.npy")
PCA_MEAN = _load("pca_mean.npy")
SVM_COEF = _load("svm_coef.npy")
SVM_INTERCEPT = _load("svm_intercept.npy")
MEL_FB = _load("mel_fb.npy")
DCT = _load("dct.npy")

SR = PARAMS["sample_rate"]
N_FFT = PARAMS["n_fft"]
HOP = PARAMS["hop_length"]
N_SAMPLES = int(PARAMS["duration"] * SR)
N_CLASSES = len(LABELS)


def hann(n):
    i = np.arange(n)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * i / n)


WIN = hann(N_FFT)


def mfcc_mean(pcm):
    """Mean MFCC vector over all frames of a [-1,1] float signal."""
    n_frames = 1 + (len(pcm) - N_FFT) // HOP
    acc = np.zeros(DCT.shape[0])
    for f in range(n_frames):
        frame = pcm[f * HOP : f * HOP + N_FFT] * WIN
        re, im = np.fft.fft(frame)
        power = re[: N_FFT // 2 + 1] ** 2 + im[: N_FFT // 2 + 1] ** 2
        mel = np.dot(MEL_FB, power)
        logmel = np.log10(np.maximum(mel, 1e-10)) * 10.0
        acc = acc + np.dot(DCT, logmel)
    return acc / n_frames


def predict(feat):
    """scaler -> pca -> linear OvO vote. Returns (class index, votes)."""
    x = (feat - SCALER_MEAN) / SCALER_SCALE
    z = np.dot(PCA_COMP, x - PCA_MEAN)
    decisions = np.dot(SVM_COEF, z) + SVM_INTERCEPT
    votes = np.zeros(N_CLASSES)
    k = 0
    for i in range(N_CLASSES):
        for j in range(i + 1, N_CLASSES):
            if decisions[k] > 0:
                votes[i] += 1
            else:
                votes[j] += 1
            k += 1
    best = int(np.argmax(votes))
    return best, votes


def led(color):
    if not HAS_HW:
        return
    for i, c in enumerate(("red", "green", "blue"), start=1):
        pyb.LED(i).off()
    idx = {"red": 1, "green": 2, "blue": 3}.get(color)
    if idx:
        pyb.LED(idx).on()


def record():
    if not HAS_HW:
        raise RuntimeError("no audio hardware; call predict() with a test vector")
    # start EMPTY and extend: preallocating N_SAMPLES*2 zeros would leave
    # the real samples beyond the slice below (classifying pure silence)
    buf = bytearray()
    audio.init(channels=1, frequency=SR, gain_db=24)
    audio.start_streaming(lambda data: buf.extend(data))
    time.sleep(PARAMS["duration"] + 0.1)
    audio.stop_streaming()
    if len(buf) < N_SAMPLES * 2:
        buf.extend(bytes(N_SAMPLES * 2 - len(buf)))  # zero-pad a short capture
    pcm = np.frombuffer(bytes(buf[: N_SAMPLES * 2]), dtype=np.int16)
    return pcm / 32768.0


def main():
    print("nicla svm runtime:", N_CLASSES, "classes @", SR, "Hz")
    while True:
        led("blue")
        try:
            pcm = record()
            feat = mfcc_mean(pcm)
            best, votes = predict(feat)
            margin = float(np.max(votes)) / max(1, N_CLASSES - 1)
            led("green" if margin > 0.6 else "red")
            print(LABELS[best], votes)
        except Exception as exc:
            led("red")
            print("error:", exc)
        time.sleep(0.5)


if __name__ == "__main__":
    main()
'''
