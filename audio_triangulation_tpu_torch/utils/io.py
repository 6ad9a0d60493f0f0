"""Audio file I/O: WAV read/write (stdlib only; a copy of the JAX package's
``utils/io``).

The reference's input is a live ADC; for offline runs this framework ingests
multi-channel WAV.  int16 and 8-bit unsigned WAV map directly onto the
pipeline's two input conventions (the 8-bit path mirrors the firmware's ADC
format, ``src/components/dma_sampler.c``).
"""

from __future__ import annotations

import wave

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (samples [channels, T], sample_rate).

    8-bit files return uint8 (ADC-style, 0..255); 16-bit return int16;
    24/32-bit are narrowed to int16."""
    with wave.open(path, "rb") as w:
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 1:
        data = np.frombuffer(raw, np.uint8)
    elif width == 2:
        data = np.frombuffer(raw, np.int16)
    elif width == 4:
        data = (np.frombuffer(raw, np.int32) >> 16).astype(np.int16)
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        val = (b[:, 0].astype(np.int32)
               | (b[:, 1].astype(np.int32) << 8)
               | (b[:, 2].astype(np.int32) << 16))
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        data = (val >> 8).astype(np.int16)
    else:
        raise ValueError(f"unsupported sample width {width}")
    return data.reshape(-1, n_ch).T.copy(), rate


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write [channels, T] int16/uint8 (or float in [-1, 1]) as WAV."""
    s = np.asarray(samples)
    if s.ndim == 1:
        s = s[None]
    if np.issubdtype(s.dtype, np.floating):
        s = np.clip(np.round(s * 32767), -32768, 32767).astype(np.int16)
    width = 1 if s.dtype == np.uint8 else 2
    with wave.open(path, "wb") as w:
        w.setnchannels(s.shape[0])
        w.setsampwidth(width)
        w.setframerate(sample_rate)
        w.writeframes(np.ascontiguousarray(s.T).tobytes())
