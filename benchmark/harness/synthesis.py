"""What the synthesis cells share: the two models from one seed, the
duration factor drawn from the seed's model, and the spans of a traced run."""

import numpy as np

from .common import program_config, reference_generator, reference_mode
from .weights import seeded_state_dict


def build_models(ctx):
    """(reference, program) on ctx.device with the same seeded weights: the
    plain reference's parameters are drawn from the seed and its state dict
    is handed to the program (`OptiSpeech(cfg, state_dict=...)`)."""
    import torch

    from optispeech_tpu_torch.models.optispeech import OptiSpeech

    ref = reference_generator(ctx.config, ctx.device).eval()
    state = seeded_state_dict(ref, ctx.seed, ctx.device)
    dtype = torch.bfloat16 if ctx.control else torch.float32
    prog = OptiSpeech(program_config(ctx.config), device=ctx.device, state_dict=state,
                      compute_dtype=dtype)
    return ref, prog


def raw_durations(ref, ids: np.ndarray, lengths: np.ndarray, device, block: int = 64):
    """The reference's frames per token before the factor and the ceiling,
    exp(log-duration) - 1e-8, (R, T) float64 with 0 past each row's length."""
    import torch

    from reference.generator import sequence_mask

    out = []
    with reference_mode():
        for i in range(0, len(lengths), block):
            x = torch.as_tensor(ids[i:i + block], device=device)
            xl = torch.as_tensor(lengths[i:i + block], device=device)
            pad = ~sequence_mask(xl, x.shape[1])
            h = ref.encoder(ref.text_embedding(x), pad)
            raw = torch.exp(ref.duration_predictor(h, pad)) - 1e-8
            out.append(raw.masked_fill(pad, 0.0).double().cpu().numpy())
    return np.concatenate(out)


def frames(raw: np.ndarray, d: float) -> np.ndarray:
    """Frames per row at duration factor d."""
    return np.maximum(np.ceil(raw * np.float32(d)), 0).sum(axis=1)


def pick_d_factor(raw: np.ndarray, lengths: np.ndarray, frames_per_token: float,
                  max_row_frames: int) -> tuple[float, float]:
    """(d, d_mean): d_mean makes the rows' mean `frames_per_token` frames a
    token; d is d_mean, lowered where needed so that no row passes
    `max_row_frames`. Both conditions rise with d: bisection on each."""
    def solve(too_high):
        lo, hi = 1e-3, 1e3
        for _ in range(80):
            mid = (lo * hi) ** 0.5
            lo, hi = (lo, mid) if too_high(mid) else (mid, hi)
        return lo

    tokens = float(np.sum(lengths))
    d_mean = solve(lambda d: frames(raw, d).sum() / tokens > frames_per_token)
    d_cap = solve(lambda d: frames(raw, d).max() > max_row_frames)
    return float(min(d_mean, d_cap)), float(d_mean)


def frame_rate_blocks(generator, gen_cfg: dict) -> list:
    """The ConvNeXt blocks that run at frame rate: the decoder's, where it
    is a ConvNeXt stack, and the vocoder trunk's, where the vocoder has one
    (WaveNeXt's `backbone.convnext`); none for a vocoder without."""
    blocks = list(getattr(getattr(generator.vocoder, "backbone", None), "convnext", []))
    if gen_cfg["decoder"]["kind"] == "convnext":
        blocks = list(generator.decoder.convnext) + blocks
    return blocks


def install_spans(spans, generator, gen_cfg: dict) -> None:
    """Spans of the synthesis layers: `decode` (L3), the decoder backbone
    (L2), every frame-rate ConvNeXt block (L0's B1, with its call shapes;
    none where the generator has no such block)."""
    spans.around_method(generator, "decode", "decode")
    spans.around_module(generator.decoder, "decoder")
    for block in frame_rate_blocks(generator, gen_cfg):
        spans.around_module(block, "b1", shape_of=lambda mod, args: (
            *args[0].shape, mod.pwconv1.out_features, args[0].element_size()))


def synthesis_flops(ref, text_width: int, n_frames: int, device) -> dict:
    """FLOPs per token and per frame of the reference's synthesis at one row
    of `text_width` tokens and `n_frames` frames (torch's FLOP counter)."""
    import torch

    from .roofline import count_flops

    x = torch.randint(3, 150, (1, text_width), device=device)
    xl = torch.tensor([text_width], device=device)
    with reference_mode():
        enc_holder = {}

        def encode():
            enc_holder.update(ref.encode(x, xl, 1.0, 1.0, 1.0))

        enc_flops = count_flops(encode)
        enc = enc_holder
        dur = torch.full_like(enc["durations"], max(n_frames // text_width, 1))
        y_len = torch.tensor([n_frames], device=device)
        dec_flops = count_flops(lambda: ref.decode(enc["hidden"], dur, enc["x_mask"], y_len,
                                                   n_frames))
    return {"per_token": enc_flops / text_width, "per_frame": dec_flops / n_frames}
