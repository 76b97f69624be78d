"""Streaming (chunked) long-form synthesis.

Port of `optispeech_tpu/models/streaming.py`. The decoder and the WaveNeXt
vocoder are strictly local (stacked k=7 convolutions: the decoder's 4
blocks reach 12 frames, the vocoder's embed and 8 blocks 27), so the
frame-rate stage runs on windows of `chunk + 2 * overlap` frames with
`overlap` frames of context on each side (the first window has none on
its left), and each window's audio is sent while the next one computes.
An overlap of at least the receptive field (48 frames by default) makes
the chunks equal the full decode away from numerical noise.

The token-rate stage (encode, Gaussian upsampling and, for an
f0-conditioned vocoder, the frame-level pitch) runs once per utterance.
"""

from collections import deque
from typing import Iterator

import numpy as np
import torch

from ..ops import expand_by_duration, gaussian_upsample, sequence_mask
from ..ops.mulaw import mulaw_encode
from .modules.convnext import ConvNeXtBackbone

# decoder (4 x k7) + vocoder (embed k7 + 8 x k7) one-sided receptive field
DEFAULT_OVERLAP = 48


def _pcm16(wav: torch.Tensor) -> torch.Tensor:
    return torch.round(torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)


_WIRE_ENCODERS = {"pcm16": _pcm16, "mulaw": mulaw_encode}


def upsample(gen, x, x_lengths, sids, lids, d, p, e, n_frames: int):
    """A stream's token-rate stage: frames (B, n_frames, C), frame-level
    pitch (or None) and the lengths capped at n_frames, as the generator's
    `decode` forms them."""
    enc = gen.encode(x, x_lengths, sids, lids, d, p, e)
    y_lengths = torch.clamp(enc["y_lengths"], max=n_frames)
    y_mask = sequence_mask(y_lengths, n_frames)
    frames = gaussian_upsample(enc["hidden"], enc["durations"].float(), y_mask, enc["x_mask"])
    f0 = None
    if gen.cfg.vocoder.f0_cond:
        # the f0-conditioned vocoder's pitch, expanded as `decode` does
        f0, _ = expand_by_duration(enc["pitch"][..., None], enc["durations"], n_frames)
        f0 = f0[..., 0] * y_mask.to(f0.dtype)
    return frames, f0, y_lengths


def decode_window(gen, frames, f0, padding_mask):
    """A stream's frame-rate stage on one window: decoder and vocoder, float32
    audio out. Frames outside the utterance are PAD for both stages, so the
    windows at its edges reproduce the full decode's zero padding. A fused
    model runs its fused blocks at the window's length, which JAX's tile
    rule does not take (352 frames at the defaults), since B1 takes any T;
    JAX runs its windows unfused. The other backbone kinds take any length."""
    kw = {"any_length": True} if isinstance(gen.decoder, ConvNeXtBackbone) else {}
    y = gen.decoder(frames, padding_mask, **kw)
    return gen.vocoder(y, f0=f0, padding_mask=padding_mask, any_length=True).float()


def window_lengths(chunk: int, overlap: int) -> list[int]:
    """The window lengths that `StreamingSynthesiser.stream` runs: the
    windows that start before frame `overlap` begin at frame 0 (less left
    context), every later one holds chunk + 2 * overlap frames."""
    return sorted({s + chunk + overlap for s in range(0, overlap, chunk)}
                  | {chunk + 2 * overlap})


class StreamingSynthesiser:
    """Wraps an OptiSpeech model with a chunked frame-rate pipeline."""

    def __init__(self, api, chunk_frames: int = 256, overlap: int = DEFAULT_OVERLAP):
        self.api = api
        self.gen = api.generator
        self.chunk = chunk_frames
        self.overlap = overlap
        self.window = chunk_frames + 2 * overlap
        self.hop = api.hop_length

    # the two stages, which an exported artifact's streamer takes from its
    # graphs (export/exporter.py::ExportedStreamingSynthesiser)
    def _upsample(self, x, x_lengths, sids, lids, d, p, e, n_frames: int):
        return upsample(self.gen, x, x_lengths, sids, lids, d, p, e, n_frames)

    def _chunk(self, frames, f0, padding_mask):
        return decode_window(self.gen, frames, f0, padding_mask)

    @staticmethod
    def _start_fetch(audio: torch.Tensor):
        """Start copying `audio` to the host. On the card the copy goes into
        pinned memory without blocking, and an event marks its end: the
        next window's launches queue behind it, so that waiting for this
        chunk does not wait for the next one's compute."""
        if audio.device.type != "cuda":
            return audio, None
        host = torch.empty(audio.shape, dtype=audio.dtype, pin_memory=True)
        host.copy_(audio, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _finish_fetch(host: torch.Tensor, done) -> np.ndarray:
        if done is not None:
            done.synchronize()
        return host.numpy()

    @torch.inference_mode()
    def stream(self, inputs, max_frames: int = 4096,
               wire: str | None = None) -> Iterator[np.ndarray]:
        """Yield the first batch item's waveform chunk by chunk (numpy).

        `wire` encodes each chunk on the device before the fetch: "pcm16"
        (int16, half the float32 bytes) or "mulaw" (uint8, a quarter;
        decode with `ops.mulaw.mulaw_decode`). None yields float32."""
        encode = None if wire is None else _WIRE_ENCODERS[wire]
        x, x_lengths, sids, lids, d, p, e = self.api._tensors(inputs)
        frames, f0, y_lengths = self._upsample(x, x_lengths, sids, lids, d, p, e, max_frames)
        total = int(y_lengths[0])  # host sync: how many windows to run

        # pad a full window on the right, so that the last window's slice
        # never overruns (short utterances too)
        b, _, c = frames.shape
        frames = torch.cat([frames, frames.new_zeros(b, self.window, c)], dim=1)
        if f0 is not None:
            f0 = torch.cat([f0, f0.new_zeros(b, self.window)], dim=1)
        pos0 = torch.arange(self.window, device=frames.device)

        start = 0
        pending = deque()  # fetches in flight: the fetch of chunk i overlaps chunk i+1
        while start < total:
            emit = min(self.chunk, total - start)
            # the window holds frames lo .. start + chunk + overlap; the first
            # one starts at frame 0 with no left context, so that its
            # convolutions pad with zeros as the full decode's do (JAX pads
            # `overlap` PAD frames there, into which the vocoder's embedding
            # convolution spills from frames 0-2: its first frames then
            # differ from the full decode's)
            lo = max(start - self.overlap, 0)
            n = start + self.chunk + self.overlap - lo
            pad_mask = (pos0[:n] + lo >= total).expand(b, n)
            window_f0 = None if f0 is None else f0[:, lo:lo + n]
            wav = self._chunk(frames[:, lo:lo + n], window_f0, pad_mask)
            s = (start - lo) * self.hop
            audio = wav[0, s:s + emit * self.hop]
            if encode is not None:
                audio = encode(audio)
            pending.append(self._start_fetch(audio))
            start += emit
            if len(pending) > 1:
                yield self._finish_fetch(*pending.popleft())
        while pending:
            yield self._finish_fetch(*pending.popleft())

    def synthesise(self, inputs, max_frames: int = 4096) -> np.ndarray:
        """The streamed chunks concatenated."""
        chunks = list(self.stream(inputs, max_frames))
        return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
