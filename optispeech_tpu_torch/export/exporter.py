"""Model export, and the runtime that replays an exported artifact.

Port of `optispeech_tpu/export/exporter.py`, the package's counterpart of
the reference's ONNX export and its minimal `ospeech` runtime: the
inference stages are saved as graphs with a self-describing `inference`
metadata blob (sample rate, inference arguments, text-processor config),
and the runtime rebuilds the text processor from that blob alone.

An artifact directory holds:
- `graphs/<key>.pt2`: one `torch.export` program per stage and shape, with
  JAX's keys: `encode_{tb}[_b{nb}]` (token rate, text bucket tb, batch
  rung nb; rung 1 has no suffix), `decode_{tb}_{mb}[_b{nb}]` (frame rate
  at mel bucket mb) and, for `/stream`, `stream_upsample_{tb}_{mb}` (encode
  and Gaussian upsampling, batch 1) and `stream_decode_{n}` (decoder and
  vocoder on one window of n frames). The port's stream starts its first
  window at frame 0 (`models/streaming.py`), so it takes one graph per
  window length (`streaming.window_lengths`: two at the defaults), where
  JAX's takes one.
- `params.pt`: every graph's first input, saved once: the generator's
  state dict, and for each block that runs fused, its parameters in B1's
  layout with B1's weight pack (`<block>.fused.<name>`, `FUSED_KEYS`).
  So the card never packs B1's weights per call: the pack is made once,
  at export, by plain tensor code that gives the same bytes on every
  device. The graphs are saved without their example inputs, which would
  hold a copy of the parameters each.
- `metadata.json`: JAX's keys and values (`inference`, `buckets`,
  `batch_sizes`, `stream`, `config`).

B1 is one node in each graph, the registered op `optispeech_tpu_torch::
convnext_block_fused` (`ops/fused_convnext.py`): the twin where the graph
runs on the CPU, the kernel where it runs on the card. So one artifact
serves on both, as JAX's serves on both its platforms. The graphs are
traced on the CPU and moved at load time (`move_to_device_pass`); they hold
no device-bound constant.
"""

import json
import os
import time
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..config import to_dict
from ..models.modules.convnext import ConvNeXtBackbone, ConvNeXtBlock
from ..models.streaming import StreamingSynthesiser, decode_window, upsample, window_lengths
from ..models.vocoder.wavenext import WaveNeXt
from ..ops.fused_convnext import OP_NAME  # noqa: F401  (registers B1's op before a load)
from ..utils.bucketing import round_up_to_bucket
from ..utils.device import resolve_device
from ..utils.pylogger import get_pylogger
from ..values import InferenceInputs, InferenceOutputs, numpy_pad_sequences

log = get_pylogger(__name__)

# a fused block's parameters in B1's layout (`ConvNeXtBlock.fused_params`)
FUSED_KEYS = ("dw", "dwb", "lnw", "lnb", "w1", "b1", "w2", "b2", "gamma", "packed")


def fused_blocks(gen) -> dict[str, ConvNeXtBlock]:
    """The generator's blocks that run fused at inference, by state-dict
    path: those of a fused backbone (the decoder) and of a fused WaveNeXt's
    trunk, with layer scale."""
    backbones = {id(m) for m in gen.modules()
                 if isinstance(m, ConvNeXtBackbone) and m.fused_pallas}
    backbones |= {id(m.backbone) for m in gen.modules()
                  if isinstance(m, WaveNeXt) and m.fused_pallas}
    return {f"{path}.convnext.{i}": block
            for path, m in gen.named_modules() if id(m) in backbones
            for i, block in enumerate(m.convnext) if block.gamma is not None}


def export_params(gen) -> dict[str, torch.Tensor]:
    """Every graph's first input: the state dict and each fused block's
    B1-layout parameters with the pack, on the CPU."""
    params = {k: v.detach().cpu() for k, v in gen.state_dict().items()}
    for path, block in fused_blocks(gen).items():
        for name, t in zip(FUSED_KEYS, block.fused_params()):
            # a copy: the float32 ones may share storage with the state
            # dict's, and a trace makes inputs that alias one another one
            params[f"{path}.fused.{name}"] = t.detach().cpu().clone()
    return params


class _Call(nn.Module):
    def __init__(self, gen, fn):
        super().__init__()
        self.gen = gen
        self.fn = fn

    def forward(self, *inputs):
        return self.fn(self.gen, *inputs)


class _Graph(nn.Module):
    """`fn(gen, *inputs)` as a function of (params, *inputs): the generator's
    parameters and the fused blocks' B1 inputs come from `params`, so the
    graph holds none of them."""

    def __init__(self, gen, fn):
        super().__init__()
        self.__dict__["_call"] = _Call(gen, fn)  # not a submodule: no state of its own
        self.__dict__["_blocks"] = fused_blocks(gen)

    def forward(self, params, *inputs):
        own = {f"gen.{k}": v for k, v in params.items() if ".fused." not in k}
        for path, block in self._blocks.items():
            block.given_fused_params = tuple(params[f"{path}.fused.{k}"] for k in FUSED_KEYS)
        try:
            return torch.func.functional_call(self._call, own, inputs)
        finally:
            for block in self._blocks.values():
                block.given_fused_params = None


def _save_graph(gen, fn, params, inputs, path):
    ep = torch.export.export(_Graph(gen, fn), (params, *inputs), strict=False)
    ep.example_inputs = None  # they would hold a copy of the parameters
    torch.export.save(ep, path)


def _factors():
    return tuple(torch.ones((), dtype=torch.float32) for _ in range(3))


def _id_inputs(nb: int, has_spk_inputs: bool):
    # two tensors: a trace given one tensor twice makes the two inputs one
    return tuple(torch.zeros(nb, dtype=torch.int64) for _ in range(2)) if has_spk_inputs else ()


def _encode_fn(has_spk_inputs):
    if has_spk_inputs:
        return lambda gen, x, x_lengths, sids, lids, d, p, e: gen.encode(
            x, x_lengths, sids, lids, d, p, e)
    return lambda gen, x, x_lengths, d, p, e: gen.encode(x, x_lengths, None, None, d, p, e)


def _decode_fn(mb: int, f0_cond: bool):
    if f0_cond:
        return lambda gen, hidden, durations, x_mask, y_lengths, pitch: gen.decode(
            hidden, durations, x_mask, y_lengths, mb, pitch=pitch)
    return lambda gen, hidden, durations, x_mask, y_lengths: gen.decode(
        hidden, durations, x_mask, y_lengths, mb)


def _text_inputs(nb: int, tb: int):
    return (torch.ones(nb, tb, dtype=torch.int64), torch.full((nb,), tb, dtype=torch.int32))


def export_model(
    model,
    output_dir: str,
    text_buckets: Sequence[int] = (32, 64, 128),
    frames_per_token: int = 12,
    mel_buckets: Sequence[int] | None = None,
    batch_sizes: Sequence[int] = (1, 2, 4, 8),
    stream_chunk_frames: int | None = 256,
    stream_overlap: int = 48,
):
    """Save the two-stage inference graphs for the given bucket ladders.

    `batch_sizes` exports a power-of-two batch ladder per text bucket, so
    that the serving batcher coalesces requests against an artifact as
    against a live checkpoint. `stream_chunk_frames` also exports the
    chunked decode used by `/stream` (upsampling, then the windowed decoder
    and vocoder); None skips it. The model is exported as it is given,
    fused blocks or not; it is traced on the CPU."""
    gen = model.generator
    graph_dir = os.path.join(output_dir, "graphs")
    os.makedirs(graph_dir, exist_ok=True)
    params = export_params(gen)
    cfg = model.cfg.generator
    has_spk_inputs = cfg.num_speakers > 1 or cfg.num_languages > 1
    f0_cond = cfg.vocoder.f0_cond
    batch_sizes = sorted(set(int(b) for b in batch_sizes))
    keys = []

    def save(key, fn, inputs):
        _save_graph(gen, fn, params, inputs, os.path.join(graph_dir, f"{key}.pt2"))
        keys.append(key)

    for tb in text_buckets:
        mels = mel_buckets or [round_up_to_bucket(tb * frames_per_token, model.mel_bucket)]
        for nb in batch_sizes:
            suffix = "" if nb == 1 else f"_b{nb}"
            save(f"encode_{tb}{suffix}", _encode_fn(has_spk_inputs),
                 (*_text_inputs(nb, tb), *_id_inputs(nb, has_spk_inputs), *_factors()))
            for mb in mels:
                hidden = torch.zeros(nb, tb, cfg.dim, dtype=gen.compute_dtype)
                durations = torch.ones(nb, tb, dtype=torch.int32)
                x_mask = torch.ones(nb, tb, dtype=torch.bool)
                y_lengths = torch.full((nb,), tb, dtype=torch.int32)
                pitch = (torch.zeros(nb, tb),) if f0_cond else ()
                save(f"decode_{tb}_{mb}{suffix}", _decode_fn(mb, f0_cond),
                     (hidden, durations, x_mask, y_lengths, *pitch))

    stream_meta = None
    if stream_chunk_frames:
        stream_meta = _export_stream_graphs(
            save, model, text_buckets, frames_per_token, stream_chunk_frames, stream_overlap,
            has_spk_inputs)

    torch.save(params, os.path.join(output_dir, "params.pt"))
    metadata = {
        "inference": {
            "name": model.cfg.run_name,
            "sample_rate": model.sample_rate,
            "hop_length": model.hop_length,
            "inference_args": {
                "d_factor": model.inference_args.d_factor,
                "p_factor": model.inference_args.p_factor,
                "e_factor": model.inference_args.e_factor,
            },
            "text_processor": model.text_processor.asdict(),
            "speakers": model.speakers,
            "num_speakers": cfg.num_speakers,
            "num_languages": cfg.num_languages,
            "has_speaker_inputs": has_spk_inputs,
            "f0_cond": f0_cond,
        },
        "buckets": sorted({int(k.split("_")[1]) for k in keys if k.startswith("encode")}),
        "batch_sizes": batch_sizes,
        "stream": stream_meta,
        "config": to_dict(model.cfg),
    }
    with open(os.path.join(output_dir, "metadata.json"), "w") as f:
        json.dump(metadata, f, indent=2)
    log.info(f"Exported {len(keys)} graphs -> {output_dir}")
    return output_dir


def _export_stream_graphs(save, model, text_buckets, frames_per_token, chunk_frames, overlap,
                          has_spk_inputs):
    """`stream_upsample_{tb}_{mb}` (encode and Gaussian upsampling to mb
    frames, batch 1) and `stream_decode_{n}` (decoder and vocoder on one
    window of n frames, for each length in `window_lengths`): the two
    stages of `models/streaming.py`, so that `/stream` replays from the
    artifact."""
    gen = model.generator
    f0_cond = model.cfg.generator.vocoder.f0_cond

    for tb in text_buckets:
        mb = round_up_to_bucket(tb * frames_per_token, model.mel_bucket)

        def upsample_fn(gen, x, x_lengths, *rest, mb=mb):
            sids, lids = rest[:2] if has_spk_inputs else (None, None)
            frames, f0, y_lengths = upsample(gen, x, x_lengths, sids, lids, *rest[-3:], mb)
            out = {"frames": frames, "y_lengths": y_lengths}
            if f0_cond:
                out["f0_frames"] = f0
            return out

        save(f"stream_upsample_{tb}_{mb}", upsample_fn,
             (*_text_inputs(1, tb), *_id_inputs(1, has_spk_inputs), *_factors()))

    def window_fn(gen, frames, *rest):
        f0 = rest[0] if f0_cond else None
        return decode_window(gen, frames, f0, rest[-1])

    for n in window_lengths(chunk_frames, overlap):
        f0 = (torch.zeros(1, n),) if f0_cond else ()
        save(f"stream_decode_{n}", window_fn,
             (torch.zeros(1, n, model.cfg.generator.dim, dtype=gen.compute_dtype), *f0,
              torch.zeros(1, n, dtype=torch.bool)))
    return {"chunk_frames": chunk_frames, "overlap": overlap,
            "window": chunk_frames + 2 * overlap, "f0_cond": f0_cond}


class ExportedOptiSpeech:
    """The runtime over an exported artifact (the reference's
    `OptiSpeechONNXModel`): the text processor rebuilt from the metadata,
    `prepare_input` / `synthesise`, latency and RTF.

    The graphs run on `device` (default: the card; raises when there is
    none): B1's kernel there, its twin on the CPU."""

    def __init__(self, path: str, device=None):
        if os.path.exists(os.path.join(path, "graphs.pkl")):
            raise ValueError(
                f"{path} is an artifact of the JAX package (graphs.pkl, StableHLO): export "
                "the checkpoint with optispeech_tpu_torch.cli.export to serve it here")
        from torch.export.passes import move_to_device_pass

        from ..text import TextProcessor

        self.device = resolve_device(device)
        with open(os.path.join(path, "metadata.json")) as f:
            self.metadata = json.load(f)
        self.params = torch.load(os.path.join(path, "params.pt"), map_location=self.device,
                                 weights_only=True)
        graph_dir = os.path.join(path, "graphs")
        self._graphs = {}
        for name in sorted(os.listdir(graph_dir)):
            ep = torch.export.load(os.path.join(graph_dir, name))
            self._graphs[name[:-len(".pt2")]] = move_to_device_pass(ep, self.device).module()

        inf = self.metadata["inference"]
        self.text_processor = TextProcessor.from_dict(inf["text_processor"])
        self.sample_rate = inf["sample_rate"]
        self.hop_length = inf["hop_length"]
        self.inference_args = inf["inference_args"]
        self.speakers = inf.get("speakers") or []
        self.num_speakers = inf.get("num_speakers", 1)
        self.num_languages = inf.get("num_languages", 1)
        self.has_speaker_inputs = inf.get("has_speaker_inputs", False)
        self.text_buckets = self.metadata["buckets"]
        # the batch rungs of each text bucket: encode_{tb} is rung 1,
        # encode_{tb}_b{N} the wider ones
        self._rungs: dict[int, list[int]] = {}
        for k in self._graphs:
            parts = k.split("_")
            if parts[0] == "encode":
                nb = int(parts[2][1:]) if len(parts) > 2 else 1
                self._rungs.setdefault(int(parts[1]), []).append(nb)
        for rungs in self._rungs.values():
            rungs.sort()
        self.stream_meta = self.metadata.get("stream")

    def prepare_input(self, text: str, lang: str | None = None,
                      speaker: str | int | None = None,
                      split_sentences: bool = False,
                      d_factor: float | None = None,
                      p_factor: float | None = None,
                      e_factor: float | None = None) -> InferenceInputs:
        """Text to ids, with the speaker and language resolved and the
        factors defaulting to the metadata's inference arguments."""
        languages = self.text_processor.languages
        if lang is None:
            lang = languages[0]
        sid = None
        if self.num_speakers > 1:
            if speaker is None:
                sid = 0
            elif isinstance(speaker, str):
                try:
                    sid = self.speakers.index(speaker)
                except (ValueError, IndexError):
                    raise ValueError(
                        f"A speaker with the given name `{speaker}` was not found in speaker list"
                    )
            else:
                sid = int(speaker)
        lid = None
        if self.text_processor.is_multi_language:
            try:
                lid = languages.index(lang)
            except (ValueError, IndexError):
                raise ValueError(
                    f"A language with the given name `{lang}` was not found in language list"
                )

        input_ids, clean_text = self.text_processor(text, lang=lang,
                                                    split_sentences=split_sentences)
        if split_sentences:
            lengths = [len(i) for i in input_ids]
        else:
            lengths = [len(input_ids)]
            input_ids = [input_ids]
        n = len(input_ids)
        return InferenceInputs.from_ids_and_lengths(
            ids=input_ids, lengths=lengths, clean_text=clean_text,
            sids=[sid] * n if sid is not None else None,
            lids=[lid] * n if lid is not None else None,
            d_factor=d_factor if d_factor is not None else self.inference_args["d_factor"],
            p_factor=p_factor if p_factor is not None else self.inference_args["p_factor"],
            e_factor=e_factor if e_factor is not None else self.inference_args["e_factor"],
        )

    def _text_bucket(self, n: int) -> int:
        return next((b for b in self.text_buckets if b >= n), self.text_buckets[-1])

    def _tensors(self, inputs: InferenceInputs, rows=None):
        """The graphs' inputs on the device: ids cut or padded to the text
        bucket that holds them, the lengths, the ids of speakers and
        languages (zeros where the inputs have none) when the graphs take
        them, and the factors as 0-d float32 tensors. `rows` picks and
        repeats rows (a batch rung's padding)."""
        inputs = inputs.as_numpy()
        tb = self._text_bucket(inputs.x.shape[1])
        rows = np.arange(inputs.x.shape[0]) if rows is None else np.asarray(rows)
        def dev(a, dtype):
            return torch.as_tensor(np.asarray(a, dtype), device=self.device)

        x = numpy_pad_sequences(inputs.x[:, :tb], tb)[rows]
        x_lengths = np.minimum(np.asarray(inputs.x_lengths)[rows], tb)
        ids = (None, None)
        if self.has_speaker_inputs:
            ids = tuple(dev(np.zeros(len(rows)) if a is None else np.asarray(a)[rows], np.int64)
                        for a in (inputs.sids, inputs.lids))
        factors = tuple(torch.tensor(float(f), dtype=torch.float32, device=self.device)
                        for f in (inputs.d_factor, inputs.p_factor, inputs.e_factor))
        return (dev(x, np.int64), dev(x_lengths, np.int32), *ids, *factors)

    def _encode_args(self, x, x_lengths, sids, lids, d, p, e):
        return (x, x_lengths, *((sids, lids) if self.has_speaker_inputs else ()), d, p, e)

    @torch.inference_mode()
    def synthesise(self, inputs: InferenceInputs) -> InferenceOutputs:
        """Batched replay up the exported rung ladder: the sentence rows pad
        to the smallest batch rung that holds them (one encode and one
        decode a slab), so that the serving batcher coalesces against an
        artifact as against a live checkpoint. The timers stop after the
        audio reaches the host."""
        inputs = inputs.as_numpy()
        tb = self._text_bucket(inputs.x.shape[1])
        n_rows = inputs.x.shape[0]
        rungs = self._rungs.get(tb, [1])

        wavs, wav_lens, durs = [], [], []
        t0 = time.perf_counter()
        row = 0
        while row < n_rows:
            count = min(n_rows - row, rungs[-1])
            nb = next(r for r in rungs if r >= count)
            w, wl, d = self._synthesise_slab(inputs, tb, row, count, nb)
            wavs += w
            wav_lens += wl
            durs += d
            row += count
        latency = (time.perf_counter() - t0) * 1000
        maxlen = max(w.shape[-1] for w in wavs)
        wav = np.stack([np.pad(w, (0, maxlen - len(w))) for w in wavs])
        wav_t = sum(wav_lens) / (self.sample_rate * 1e-3)
        return InferenceOutputs(
            wav=wav, wav_lengths=np.asarray(wav_lens), latency=latency,
            rtf=latency / max(wav_t, 1e-9),
            durations=numpy_pad_sequences(durs) if durs else None,
        )

    def _graph(self, kind: str, tb: int, nb: int, mb: int | None = None):
        base = f"{kind}_{tb}" if mb is None else f"{kind}_{tb}_{mb}"
        return self._graphs[base if nb == 1 else f"{base}_b{nb}"]

    def _decode_buckets(self, tb: int, nb: int) -> list[int]:
        suffix = "" if nb == 1 else f"_b{nb}"
        out = []
        for k in self._graphs:
            parts = k.split("_")
            if parts[0] == "decode" and int(parts[1]) == tb and k.endswith(suffix):
                if nb == 1 and len(parts) > 3:
                    continue  # a _b{N} rung, not rung 1
                out.append(int(parts[2]))
        return sorted(out)

    def _synthesise_slab(self, inputs, tb: int, row: int, count: int, nb: int):
        """One encode and one decode over rows [row, row + count) padded up
        to batch rung `nb` (the pad rows repeat the slab's first row)."""
        pick = list(range(row, row + count)) + [row] * (nb - count)
        enc = self._graph("encode", tb, nb)(
            self.params, *self._encode_args(*self._tensors(inputs, pick)))
        y_len = enc["y_lengths"].cpu().numpy()  # host sync: picks the mel bucket
        decs = self._decode_buckets(tb, nb)
        y_max = int(y_len[:count].max())
        mb = next((m for m in decs if m >= y_max), decs[-1])
        y_lengths = torch.as_tensor(np.minimum(y_len, mb).astype(np.int32), device=self.device)
        f0 = (enc["pitch"],) if self.metadata["inference"].get("f0_cond") else ()
        dec = self._graph("decode", tb, nb, mb)(
            self.params, enc["hidden"], enc["durations"], enc["x_mask"], y_lengths, *f0)
        wav = dec["wav"].cpu().numpy()
        wav_lengths = dec["wav_lengths"].cpu().numpy()
        durations = enc["durations"].cpu().numpy()
        return ([wav[i] for i in range(count)], [int(wav_lengths[i]) for i in range(count)],
                [durations[i] for i in range(count)])


class ExportedStreamingSynthesiser(StreamingSynthesiser):
    """Chunked synthesis replayed from an artifact's stream graphs: the live
    streamer (`models/streaming.py`) with its two stages taken from the
    graphs, so the same API, windows and output, and the fetch of window i
    under window i+1's compute. Needs an artifact exported with
    `stream_chunk_frames`."""

    def __init__(self, exported: ExportedOptiSpeech):
        if not exported.stream_meta:
            raise ValueError("the artifact has no stream graphs; re-export with "
                             "export_model(..., stream_chunk_frames=256)")
        meta = exported.stream_meta
        self.api = exported
        self.chunk = meta["chunk_frames"]
        self.overlap = meta["overlap"]
        self.window = meta["window"]
        self.hop = exported.hop_length
        self._ups: dict[int, tuple[int, object]] = {}  # tb -> (mb, stream_upsample_{tb}_{mb})
        for k, g in exported._graphs.items():
            parts = k.split("_")
            if parts[:2] == ["stream", "upsample"]:
                self._ups[int(parts[2])] = (int(parts[3]), g)

    def _upsample(self, x, x_lengths, sids, lids, d, p, e, n_frames: int):
        mb, graph = self._ups[x.shape[1]]
        out = graph(self.api.params, *self.api._encode_args(x, x_lengths, sids, lids, d, p, e))
        return out["frames"], out.get("f0_frames"), torch.clamp(out["y_lengths"], max=n_frames)

    def _chunk(self, frames, f0, padding_mask):
        graph = self.api._graphs[f"stream_decode_{frames.shape[1]}"]
        return graph(self.api.params, frames, *(() if f0 is None else (f0,)), padding_mask)
