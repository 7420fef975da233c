"""Port copy of turbo_whisper_workspace_tpu/audio/io.py. One deliberate
deviation: decode_opus sizes its buffer with the stream's pre-skip
(RFC 7845 allows any value), where the JAX copy drops the tail of a
stream whose pre-skip exceeds 5760 samples.

Audio decode / resample / normalize — the host-side data loader.

Reference behavior being rebuilt (vocalis/core/audio_utils.py:17-158):
a decode cascade returning mono float32 peak-normalized PCM, degrading
to 0.1 s of silence on total failure (`:76`); duration probing;
format conversion; dBFS gain normalization.

TPU-native differences: decoding is first-party (native/flac_decoder.cpp,
native/mp3_decoder.cpp, native/aac_decoder.cpp — MP4/M4A + ADTS — via
ctypes + stdlib WAV) instead of soundfile/librosa/pydub→ffmpeg, and
resampling is a polyphase filter on host feeding fixed-shape float32
batches to the device. FLAC decode is verified against the STREAMINFO
MD5 of the unencoded PCM; the MP3 and AAC decoders are validated
bit-faithfully against reference decoders in tests/test_mp3.py and
tests/test_aac.py.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import struct
import wave

import numpy as np

from ..utils.native import load_native

logger = logging.getLogger(__name__)

TARGET_SR = 16_000


class AudioDecodeError(Exception):
    pass


# ---------------------------------------------------------------------------
# FLAC (native decoder)


def _flac_lib():
    lib = load_native("flac_decoder")
    lib.flac_stream_info.restype = ctypes.c_int
    lib.flac_stream_info.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.flac_decode.restype = ctypes.c_longlong
    lib.flac_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong,
    ]
    return lib


def flac_stream_info(data: bytes) -> dict:
    lib = _flac_lib()
    info = (ctypes.c_uint32 * 5)()
    md5 = (ctypes.c_uint8 * 16)()
    rc = lib.flac_stream_info(data, len(data), info, md5)
    if rc != 0:
        raise AudioDecodeError(f"not a FLAC stream (rc={rc})")
    return {
        "sample_rate": info[0],
        "channels": info[1],
        "bits_per_sample": info[2],
        "total_samples": info[3] | (info[4] << 32),
        "md5": bytes(md5),
    }


def _pcm_md5(samples: np.ndarray, bits: int) -> bytes:
    """MD5 of interleaved little-endian signed PCM (FLAC STREAMINFO spec)."""
    flat = samples.reshape(-1)
    if bits == 8:
        raw = flat.astype(np.int8).tobytes()
    elif bits == 16:
        raw = flat.astype("<i2").tobytes()
    elif bits == 24:
        b32 = flat.astype("<i4").tobytes()
        arr = np.frombuffer(b32, np.uint8).reshape(-1, 4)
        raw = arr[:, :3].tobytes()
    elif bits == 32:
        raw = flat.astype("<i4").tobytes()
    else:
        raise AudioDecodeError(f"unsupported bit depth {bits}")
    return hashlib.md5(raw).digest()


def decode_flac(data: bytes, verify_md5: bool = True) -> tuple[np.ndarray, int]:
    """FLAC bytes → (samples (n, channels) int32, sample_rate)."""
    info = flac_stream_info(data)
    total = info["total_samples"]
    if total == 0:
        total = len(data) * 4 // max(info["channels"], 1)  # generous bound
    lib = _flac_lib()
    out = np.zeros((total, info["channels"]), np.int32)
    n = lib.flac_decode(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), total,
    )
    if n < 0:
        raise AudioDecodeError(f"FLAC decode failed (rc={n})")
    out = out[: int(n)]
    if verify_md5 and info["md5"] != b"\x00" * 16:
        got = _pcm_md5(out, info["bits_per_sample"])
        if got != info["md5"]:
            raise AudioDecodeError("FLAC MD5 mismatch — decoder bug or corrupt file")
    return out, info["sample_rate"]


# ---------------------------------------------------------------------------
# MP3 (native decoder)


def _mp3_lib():
    lib = load_native("mp3_decoder")
    lib.mp3_info.restype = ctypes.c_long
    lib.mp3_info.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.mp3_decode.restype = ctypes.c_long
    lib.mp3_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    return lib


def mp3_stream_info(data: bytes) -> dict:
    """Scan frame headers: {sample_rate, channels, total_samples} (the
    sample count is the frame-grid upper bound, pre bit-reservoir warmup)."""
    lib = _mp3_lib()
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    n = lib.mp3_info(data, len(data), ctypes.byref(sr), ctypes.byref(ch))
    if n < 0:
        raise AudioDecodeError("not an MPEG Layer III stream")
    return {"sample_rate": sr.value, "channels": ch.value, "total_samples": n}


def decode_mp3(data: bytes) -> tuple[np.ndarray, int]:
    """MP3 bytes → (float32 samples (n, ch) in [-1,1], sample_rate)."""
    info = mp3_stream_info(data)
    lib = _mp3_lib()
    cap = info["total_samples"] + 2 * 1152
    out = np.zeros(cap * info["channels"], np.float32)
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    n = lib.mp3_decode(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap,
        ctypes.byref(sr), ctypes.byref(ch),
    )
    if n < 0:
        raise AudioDecodeError("MP3 decode failed")
    return out[: n * ch.value].reshape(-1, ch.value), sr.value


def _looks_like_mp3(data: bytes) -> bool:
    if data[:3] == b"ID3":
        return True
    return len(data) > 4 and data[0] == 0xFF and (data[1] & 0xE0) == 0xE0


# ---------------------------------------------------------------------------
# AAC / M4A (native decoder — MP4 demux + AAC-LC core,
# native/aac_decoder.cpp; oracle-tested vs libavcodec in tests/test_aac.py)


def _aac_lib():
    lib = load_native("aac_decoder")
    lib.aac_info.restype = ctypes.c_long
    lib.aac_info.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.aac_decode.restype = ctypes.c_long
    lib.aac_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    return lib


def aac_stream_info(data: bytes) -> dict:
    """{sample_rate, channels, total_samples(bound)} for M4A/ADTS bytes."""
    lib = _aac_lib()
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    n = lib.aac_info(data, len(data), ctypes.byref(sr), ctypes.byref(ch))
    if n < 0:
        raise AudioDecodeError("not an MP4/ADTS AAC stream")
    return {"sample_rate": sr.value, "channels": ch.value, "total_samples": n}


def decode_aac(data: bytes) -> tuple[np.ndarray, int]:
    """M4A/ADTS bytes → (float32 samples (n, ch) in [-1,1], sample_rate)."""
    info = aac_stream_info(data)
    lib = _aac_lib()
    cap = info["total_samples"] + 2048
    out = np.zeros(cap * max(info["channels"], 1), np.float32)
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    n = lib.aac_decode(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap,
        ctypes.byref(sr), ctypes.byref(ch),
    )
    if n < 0:
        raise AudioDecodeError(f"AAC decode failed (rc={n})")
    return out[: n * ch.value].reshape(-1, ch.value), sr.value


def _looks_like_aac(data: bytes) -> bool:
    if len(data) > 12 and data[4:8] == b"ftyp":
        return True  # ISO-BMFF (m4a/mp4)
    # ADTS sync: layer bits 00 distinguish it from MPEG audio layer III
    return len(data) > 4 and data[0] == 0xFF and (data[1] & 0xF6) == 0xF0


# ---------------------------------------------------------------------------
# Ogg Vorbis (native decoder — Ogg demux + Vorbis I core,
# native/vorbis_decoder.cpp; oracle-tested vs libavcodec in
# tests/test_vorbis.py)


def _vorbis_lib():
    lib = load_native("vorbis_decoder")
    lib.vorbis_info.restype = ctypes.c_long
    lib.vorbis_info.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.vorbis_decode.restype = ctypes.c_long
    lib.vorbis_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    return lib


def _is_ogg_opus(data: bytes) -> bool:
    """An Ogg stream whose first (BOS) packet is OpusHead (RFC 7845)."""
    # BOS page: 27-byte header + lacing; the first packet body follows
    if len(data) < 28 or data[:4] != b"OggS":
        return False
    nsegs = data[26]
    body = 27 + nsegs
    return data[body:body + 8] == b"OpusHead"


def _opus_lib():
    lib = load_native("opus_decoder")
    lib.opus_file_info.restype = ctypes.c_long
    lib.opus_file_info.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.opus_file_decode.restype = ctypes.c_long
    lib.opus_file_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_float),
        ctypes.c_long, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    return lib


def opus_stream_info(data: bytes) -> dict:
    lib = _opus_lib()
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    n = lib.opus_file_info(data, len(data), ctypes.byref(sr), ctypes.byref(ch))
    if n < 0:
        raise AudioDecodeError(f"opus info failed ({n})")
    return {"total_samples": int(n), "sample_rate": sr.value,
            "channels": ch.value}


def _opus_pre_skip(data: bytes) -> int:
    """Pre-skip field of the OpusHead packet (RFC 7845 §5.1: uint16 LE
    at byte 10 of the packet)."""
    body = 27 + data[26]
    return struct.unpack_from("<H", data, body + 10)[0]


def decode_opus(data: bytes) -> tuple[np.ndarray, int]:
    """First-party Ogg Opus decode (native/opus_decoder.cpp) →
    (float32 (N,) or (N, ch), 48000)."""
    info = opus_stream_info(data)
    lib = _opus_lib()
    # the decoder writes the pre-skip samples into the buffer before
    # trimming them, so the bound must include them
    cap = (info["total_samples"] + _opus_pre_skip(data) + 5760) * info["channels"]
    out = np.zeros(cap, np.float32)
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    n = lib.opus_file_decode(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cap, ctypes.byref(sr), ctypes.byref(ch))
    if n < 0:
        raise AudioDecodeError(f"opus decode failed ({n})")
    pcm = out[: n * ch.value]
    if ch.value > 1:
        pcm = pcm.reshape(-1, ch.value)
    return pcm, sr.value


def vorbis_stream_info(data: bytes) -> dict:
    lib = _vorbis_lib()
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    n = lib.vorbis_info(data, len(data), ctypes.byref(sr), ctypes.byref(ch))
    if n < 0:
        raise AudioDecodeError("not an Ogg Vorbis stream")
    return {"sample_rate": sr.value, "channels": ch.value, "total_samples": n}


def decode_vorbis(data: bytes) -> tuple[np.ndarray, int]:
    """Ogg Vorbis bytes → (float32 samples (n, ch) in [-1,1], rate)."""
    info = vorbis_stream_info(data)
    lib = _vorbis_lib()
    cap = info["total_samples"] + 8192
    out = np.zeros(cap * max(info["channels"], 1), np.float32)
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    n = lib.vorbis_decode(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap,
        ctypes.byref(sr), ctypes.byref(ch),
    )
    if n < 0:
        raise AudioDecodeError(f"Vorbis decode failed (rc={n})")
    return out[: n * ch.value].reshape(-1, ch.value), sr.value


# ---------------------------------------------------------------------------
# WAV (stdlib)


def decode_wav(data: bytes) -> tuple[np.ndarray, int, int]:
    """WAV bytes → (samples (n, ch) int32, sample_rate, bits_per_sample)."""
    import io as _io

    with wave.open(_io.BytesIO(data)) as w:
        sr = w.getframerate()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        arr = np.frombuffer(raw, "<i2").astype(np.int32)
    elif width == 4:
        arr = np.frombuffer(raw, "<i4")
    elif width == 1:  # WAV 8-bit is unsigned
        arr = np.frombuffer(raw, np.uint8).astype(np.int32) - 128
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        arr = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        arr = (arr << 8) >> 8  # sign-extend 24-bit
    else:
        raise AudioDecodeError(f"unsupported WAV sample width {width}")
    return arr.reshape(-1, ch), sr, width * 8


def write_wav(path: str, audio: np.ndarray, sr: int = TARGET_SR) -> None:
    """float32 [-1,1] (n,) or (n,ch) → 16-bit PCM WAV."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[:, None]
    pcm = np.clip(audio, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(audio.shape[1])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


# ---------------------------------------------------------------------------
# Resampling + the public decode cascade


def resample(audio: np.ndarray, sr: int, target_sr: int = TARGET_SR) -> np.ndarray:
    if sr == target_sr:
        return audio
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr, target_sr)
    return resample_poly(audio, target_sr // g, sr // g).astype(np.float32)


def _to_float_mono(samples: np.ndarray, bits: int) -> np.ndarray:
    x = samples.astype(np.float32)
    if x.ndim == 2:
        x = x.mean(axis=1)
    scale = float(1 << (bits - 1))
    return x / scale


def read_audio_file(
    path: str, target_sr: int = TARGET_SR, normalize: bool = True
) -> tuple[np.ndarray, int]:
    """Decode any supported file → (mono float32 @ target_sr, target_sr).

    Decode cascade with degrade-to-silence on total failure, mirroring
    vocalis/core/audio_utils.py:17-76 (which returns 0.1 s of silence).
    """
    try:
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] == b"fLaC":
            info = flac_stream_info(data)
            samples, sr = decode_flac(data)
            audio = _to_float_mono(samples, info["bits_per_sample"])
        elif data[:4] == b"RIFF":
            samples, sr, bits = decode_wav(data)
            audio = _to_float_mono(samples, bits)
        elif _looks_like_aac(data):
            samples, sr = decode_aac(data)
            audio = samples.mean(axis=1) if samples.ndim == 2 else samples
        elif _is_ogg_opus(data):
            samples, sr = decode_opus(data)
            audio = samples.mean(axis=1) if samples.ndim == 2 else samples
        elif data[:4] == b"OggS":
            samples, sr = decode_vorbis(data)
            audio = samples.mean(axis=1) if samples.ndim == 2 else samples
        elif _looks_like_mp3(data):
            # an ID3 tag can front either stream. The ADTS sniffer is
            # strict (exact sync + layer bits right after the tag) while
            # the MP3 frame scanner can false-positive on AAC payload
            # bytes — so probe AAC first, fall back to MP3.
            try:
                samples, sr = decode_aac(data)
            except AudioDecodeError:
                samples, sr = decode_mp3(data)
            audio = samples.mean(axis=1) if samples.ndim == 2 else samples
        else:
            raise AudioDecodeError(f"unrecognized container: {path}")
        audio = resample(audio, sr, target_sr)
        if normalize:
            peak = np.abs(audio).max()
            if peak > 0:
                audio = audio / peak
        return audio.astype(np.float32), target_sr
    except Exception as e:  # degrade-and-continue, like the reference
        logger.error("audio decode failed for %s: %s — returning silence", path, e)
        return np.zeros(int(0.1 * target_sr), np.float32), target_sr


def get_audio_duration(path: str) -> float:
    """Duration in seconds without full decode where possible
    (reference: vocalis/core/audio_utils.py:78-98)."""
    try:
        with open(path, "rb") as f:
            head = f.read(64)
        if head[:4] == b"fLaC":
            with open(path, "rb") as f:
                info = flac_stream_info(f.read())
            return info["total_samples"] / info["sample_rate"]
        if head[:4] == b"RIFF":
            with wave.open(path) as w:
                return w.getnframes() / w.getframerate()
        if _looks_like_aac(head):
            with open(path, "rb") as f:
                info = aac_stream_info(f.read())
            return info["total_samples"] / info["sample_rate"]
        if head[:4] == b"OggS":
            with open(path, "rb") as f:
                data = f.read()
            info = (opus_stream_info(data) if _is_ogg_opus(data)
                    else vorbis_stream_info(data))
            return info["total_samples"] / info["sample_rate"]
        if _looks_like_mp3(head):
            with open(path, "rb") as f:
                info = mp3_stream_info(f.read())
            return info["total_samples"] / info["sample_rate"]
        audio, sr = read_audio_file(path)
        return len(audio) / sr
    except Exception:
        return 0.0


def convert_audio_format(
    in_path: str, out_path: str, sample_rate: int = TARGET_SR, channels: int = 1
) -> str:
    """Re-encode to WAV at the requested rate/channels
    (reference: vocalis/core/audio_utils.py:100-132; pydub there)."""
    audio, sr = read_audio_file(in_path, target_sr=sample_rate, normalize=False)
    if channels > 1:
        audio = np.repeat(audio[:, None], channels, axis=1)
    write_wav(out_path, audio, sample_rate)
    return out_path


def normalize_audio(audio: np.ndarray, target_db: float = -20.0) -> np.ndarray:
    """Gain to a target dBFS RMS (reference: vocalis/core/audio_utils.py:134-158)."""
    rms = float(np.sqrt(np.mean(np.square(audio)))) if audio.size else 0.0
    if rms <= 0:
        return audio
    gain = 10.0 ** (target_db / 20.0) / rms
    return np.clip(audio * gain, -1.0, 1.0).astype(np.float32)
