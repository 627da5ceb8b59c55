"""Audio file IO: RIFF WAV (PCM16) and NIST SPHERE.

A copy of ``template_speech_recognition_tpu.io.audio`` (the port keeps
its own): the same samples bit for bit, the same errors.  TIMIT ships
NIST SPHERE files (often with a ``.wav`` extension), so both containers
are read here with the standard library and numpy.  ``read_audio``
sniffs the magic bytes and dispatches.

Only linear PCM is read; compressed SPHERE codings (shorten, ulaw) and
sample widths other than 1 and 2 bytes raise ``NotImplementedError``,
as in the reference: they are codings the reader refuses, not
unported work.
"""

from __future__ import annotations

import struct
import wave

import numpy as np

_SPHERE_MAGIC = b"NIST_1A"
_SPHERE_HEADER_BYTES = 1024


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """RIFF WAV -> (float32 waveform in [-1, 1], sample_rate).

    Multi-channel audio is averaged to mono.
    """
    with wave.open(path, "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        width = f.getsampwidth()
        channels = f.getnchannels()
        raw = f.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise NotImplementedError(f"sample width {width} not supported")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x, sr


def write_wav(path: str, waveform: np.ndarray, sample_rate: int) -> None:
    """float32 [-1, 1] -> 16-bit mono RIFF WAV."""
    pcm = np.clip(np.asarray(waveform, dtype=np.float64), -1.0, 1.0)
    pcm = np.round(pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def _parse_sphere_header(header: bytes) -> dict[str, str | int]:
    lines = header.decode("ascii", errors="replace").split("\n")
    fields: dict[str, str | int] = {}
    for line in lines[2:]:
        line = line.strip()
        if line == "end_head" or not line:
            continue
        parts = line.split(" ", 2)
        if len(parts) != 3:
            continue
        key, typ, val = parts
        if typ.startswith("-i"):
            fields[key] = int(val)
        else:
            fields[key] = val
    return fields


def read_sphere(path: str) -> tuple[np.ndarray, int]:
    """NIST SPHERE -> (float32 waveform in [-1, 1], sample_rate)."""
    with open(path, "rb") as f:
        head = f.read(_SPHERE_HEADER_BYTES)
        if not head.startswith(_SPHERE_MAGIC):
            raise ValueError(f"{path}: not a NIST SPHERE file")
        fields = _parse_sphere_header(head)
        data = f.read()
    coding = str(fields.get("sample_coding", "pcm"))
    if "pcm" not in coding:
        raise NotImplementedError(f"{path}: sample_coding={coding!r} not supported")
    nbytes = int(fields.get("sample_n_bytes", 2))
    count = int(fields.get("sample_count", len(data) // max(nbytes, 1)))
    byte_fmt = str(fields.get("sample_byte_format", "01"))
    if nbytes == 2:
        dtype = "<i2" if byte_fmt == "01" else ">i2"
        x = np.frombuffer(data[: count * 2], dtype=dtype).astype(np.float32) / 32768.0
    elif nbytes == 1:
        x = (np.frombuffer(data[:count], dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise NotImplementedError(f"{path}: sample_n_bytes={nbytes} not supported")
    channels = int(fields.get("channel_count", 1))
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return x, int(fields.get("sample_rate", 16000))


def write_sphere(path: str, waveform: np.ndarray, sample_rate: int) -> None:
    """float32 [-1, 1] -> 16-bit little-endian PCM NIST SPHERE."""
    pcm = np.clip(np.asarray(waveform, dtype=np.float64), -1.0, 1.0)
    pcm = np.round(pcm * 32767.0).astype("<i2")
    header_body = (
        f"sample_rate -i {sample_rate}\n"
        f"channel_count -i 1\n"
        f"sample_n_bytes -i 2\n"
        f"sample_count -i {len(pcm)}\n"
        f"sample_byte_format -s2 01\n"
        f"sample_coding -s3 pcm\n"
        "end_head\n"
    )
    header = b"NIST_1A\n   1024\n" + header_body.encode("ascii")
    if len(header) > _SPHERE_HEADER_BYTES:
        raise ValueError("SPHERE header too long")
    header = header.ljust(_SPHERE_HEADER_BYTES, b" ")
    with open(path, "wb") as f:
        f.write(header)
        f.write(pcm.tobytes())


def read_audio_info(path: str) -> tuple[int, int]:
    """(num_samples, sample_rate) from the container header alone --
    no sample decode.  The per-process input pipeline uses this to
    bucket and batch the whole corpus while decoding only the rows
    its own data shard feeds."""
    with open(path, "rb") as f:
        head = f.read(_SPHERE_HEADER_BYTES)
    if head.startswith(_SPHERE_MAGIC):
        fields = _parse_sphere_header(head)
        coding = str(fields.get("sample_coding", "pcm"))
        if "pcm" not in coding:
            # matches read_sphere: compressed codings would otherwise
            # yield bogus counts silently at metadata time
            raise NotImplementedError(
                f"{path}: sample_coding={coding!r} not supported"
            )
        nbytes = int(fields.get("sample_n_bytes", 2))
        count = int(fields.get("sample_count", 0))
        if count == 0:
            import os as _os

            count = (
                _os.path.getsize(path) - _SPHERE_HEADER_BYTES
            ) // max(nbytes, 1)
        # read_sphere averages interleaved channels to mono and returns
        # count/channels samples; report the same mono length here so
        # lazy feeding's valid_samples matches the decoded waveform
        channels = max(int(fields.get("channel_count", 1)), 1)
        return count // channels, int(fields.get("sample_rate", 16000))
    with wave.open(path, "rb") as f:
        return f.getnframes(), f.getframerate()


def read_audio(path: str) -> tuple[np.ndarray, int]:
    """Sniff magic bytes and dispatch to the right reader."""
    with open(path, "rb") as f:
        magic = f.read(7)
    if magic.startswith(_SPHERE_MAGIC):
        return read_sphere(path)
    return read_wav(path)
