"""The int8 A/B of the fused ConvNeXt block (port of `scripts/int8_ab.py`).

    python -m optispeech_tpu_torch.cli.int8_ab [--batch 32] [--t 1792] [--device cpu]

Times an 8-block trunk at the WaveNeXt shape (dim 384, intermediate 1152;
batch 32, T 1792 by default), x in bfloat16, under three arms, and holds each
against the f32 oracle:
- `xla_bf16`: the unfused block in bfloat16 through PyTorch's own operators
  (conv1d, layer_norm, linear, exact gelu); the name is the JAX script's;
- `fused_bf16`: the fused block, bf16 products (kernel B1);
- `fused_int8`: the int8 fused block, dynamic per-frame activation scales and
  per-channel weight scales (kernel B2);
- the oracle: the unfused block in float32, TF32 off.
For each it prints the wall ms per call (synchronised), the device ms from
CUDA events, the error relative to max|oracle| and the correlation, then the
int8 arm's speed-up over `fused_bf16`. The entry point runs on the card unless
given `--device cpu`, where the fused arms run their plain twins and no device
time exists. `main` returns the printed numbers.
"""

import argparse
import statistics
import time

import torch

from ..ops import fused_convnext as fc
from ..utils.device import resolve_device

C, INTER, N_BLOCKS = 384, 1152, 8


def make_params(gen: torch.Generator, device="cpu") -> dict:
    """The JAX script's parameters: normal draws at scale 0.02 for dw, w1 and
    w2 (from `gen`, in that order), zero biases, unit LayerNorm scale and a
    layer scale of 1/8."""
    s = 0.02
    p = dict(
        dw=torch.randn(7, C, generator=gen) * s,
        dwb=torch.zeros(C),
        lnw=torch.ones(C),
        lnb=torch.zeros(C),
        w1=torch.randn(C, INTER, generator=gen) * s,
        b1=torch.zeros(INTER),
        w2=torch.randn(INTER, C, generator=gen) * s,
        b2=torch.zeros(C),
        gamma=torch.full((C,), 1.0 / N_BLOCKS),
    )
    return {k: v.to(device) for k, v in p.items()}


def unfused_block(x, p, dtype):
    """`xla_block` of the JAX script, its casts included: the block in
    `dtype` with PyTorch's operators, LayerNorm in float32, the residual in
    x's dtype."""
    f = torch.nn.functional
    c = x.shape[-1]
    xf = x.to(dtype)
    acc = f.conv1d(xf.transpose(1, 2), p["dw"].t().unsqueeze(1).to(dtype), p["dwb"].to(dtype),
                   padding=3, groups=c).transpose(1, 2)
    h = f.layer_norm(acc.float(), (c,), p["lnw"], p["lnb"], eps=1e-6).to(dtype)
    h1 = f.gelu(f.linear(h, p["w1"].t().to(dtype), p["b1"].to(dtype)), approximate="none")
    h2 = f.linear(h1, p["w2"].t().to(dtype), p["b2"].to(dtype))
    return (x + p["gamma"].to(x.dtype) * h2.to(x.dtype)).to(x.dtype)


def trunk(block_fn, x):
    for _ in range(N_BLOCKS):
        x = block_fn(x)
    return x


def arms(p) -> dict:
    """The trunk of each arm, x -> x; the oracle last."""
    block = (p["dw"], p["dwb"], p["lnw"], p["lnb"])
    bf16 = (*block, p["w1"].bfloat16(), p["b1"], p["w2"].bfloat16(), p["b2"], p["gamma"])
    packed = fc.kernel_weights(bf16[4], bf16[6])  # once per arm, as the model keeps it
    f32 = (*block, p["w1"], p["b1"], p["w2"], p["b2"], p["gamma"])
    packed_int8 = fc.kernel_weights_int8(p["w1"], p["w2"])  # the 8 blocks share their weights
    return {
        "xla_bf16": lambda x: trunk(lambda x: unfused_block(x, p, torch.bfloat16), x),
        "fused_bf16": lambda x: trunk(lambda x: fc.convnext_block_fused(x, *bf16, packed=packed),
                                      x),
        "fused_int8": lambda x: trunk(
            lambda x: fc.convnext_block_fused_int8(x, *f32, packed=packed_int8), x),
        "oracle_f32": lambda x: trunk(lambda x: unfused_block(x, p, torch.float32), x),
    }


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, x, n_trials=5, n_iter=10):
    """Median over trials of the mean wall time of `n_iter` synchronised
    calls, after one warm-up; returns (seconds, last output)."""
    out = fn(x)
    _sync(x.device)
    ts = []
    for _ in range(n_trials):
        t0 = time.perf_counter()
        for _ in range(n_iter):
            out = fn(x)
            _sync(x.device)
        ts.append((time.perf_counter() - t0) / n_iter)
    return statistics.median(ts), out


def device_seconds(fn, x, n_iter=10):
    """Median device time of one call from CUDA events (None off the card)."""
    if x.device.type != "cuda":
        return None
    spans = []
    for _ in range(n_iter):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(x)
        end.record()
        end.synchronize()
        spans.append(start.elapsed_time(end) / 1e3)
    return statistics.median(spans)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="The JAX script's --t-tile is left out: the CUDA kernels take any T and no "
               "tile choice.")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--t", type=int, default=1792)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; `cpu` when asked)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the A/B; returns {arm: {"wall_ms", "device_ms", "rel_err", "corr",
    "calls"}} and "speedup" (the int8 arm over fused_bf16, device time where
    measured, else wall)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    p = make_params(torch.Generator().manual_seed(0), device)
    x = (torch.randn(args.batch, args.t, C, generator=torch.Generator().manual_seed(1)) * 0.5
         ).to(device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"batch={args.batch} T={args.t} C={C} I={INTER} blocks={N_BLOCKS} device={name}",
          flush=True)

    calls = {}

    def counted(arm, fn):
        def call(x):
            calls[arm] += 1
            return fn(x)
        calls[arm] = 0
        return call

    fns = {arm: counted(arm, fn) for arm, fn in arms(p).items()}
    with torch.no_grad():
        ref = fns["oracle_f32"](x).float()
        scale = ref.abs().max()
        result = {}
        for arm, fn in fns.items():
            xin = x if arm == "oracle_f32" else x.bfloat16()
            wall, out = timed(fn, xin)
            dev = device_seconds(fn, xin)
            o = out.float()
            err = float((o - ref).abs().max() / scale)
            corr = float(torch.corrcoef(torch.stack([o.ravel(), ref.ravel()]).double())[0, 1])
            result[arm] = {"wall_ms": wall * 1e3, "device_ms": dev * 1e3 if dev else None,
                           "rel_err": err, "corr": corr, "calls": calls[arm]}
            dev_ms = f"{dev * 1e3:8.3f}" if dev else "     n/a"
            print(f"{arm:12s} wall {wall * 1e3:8.3f} ms/call   device {dev_ms} ms"
                  f"   rel-err {err:.4g}   corr {corr:.6f}", flush=True)
    base, mine = result["fused_bf16"], result["fused_int8"]
    clock = "device" if mine["device_ms"] else "wall"
    result["speedup"] = base[f"{clock}_ms"] / mine[f"{clock}_ms"]
    print(f"int8 speedup vs fused_bf16 ({clock}): {result['speedup']:.3f}x", flush=True)
    return result


if __name__ == "__main__":
    main()
