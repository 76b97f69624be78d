"""Training a voice: the GAN step of `training/step.py::make_train_step`, the
step `Trainer.fit` calls, back to back on batches made on the device.

Workload parameters (`workloads/<cell>.json`, "params"):
- batch, t_text, t_mel: rows a step and their padded token and frame widths.
- seconds_mean, seconds_sd, seconds_clip: each row's clip length in seconds
  (LJSpeech-like), its frames at the configuration's hop and rate, cut to
  t_mel; tokens_per_second: its tokens, cut to t_text.
- pool: distinct batches made at set-up and cycled; sizes_seed: the row
  lengths, the same for every run (`--seed` shuffles them and draws the
  ids, features, waveforms, segment starts and weights).
- overrides: dotted configuration keys set for this cell (the
  discriminators train from the first step).

Set-up builds one training state from the seed and drives it through its
first `compared_steps` steps, on distinct batches, through the same call
the window uses: those steps are what the check holds against the
reference. `train_step_ms` is the window's wall over the steps completed in
it, the last one synchronised.
"""

import copy
import time

import numpy as np

from harness.common import reference_mode


def with_overrides(cfg: dict, overrides: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    for path, value in overrides.items():
        node = cfg["config"]
        *head, last = path.split(".")
        for key in head:
            node = node[key]
        if last not in node:
            raise KeyError(f"unknown configuration key {path}")
        node[last] = value
    return cfg


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.workload["params"]
        self.cfg = with_overrides(ctx.config, self.p.get("overrides", {}))

    # -- traffic --------------------------------------------------------
    def lengths(self):
        """(token lengths, frame lengths) of every row of the pool."""
        p, g = self.p, self.cfg["config"]["generator"]
        n = p["batch"] * p["pool"]
        r = np.random.default_rng(p["sizes_seed"])
        secs = np.clip(r.normal(p["seconds_mean"], p["seconds_sd"], n), *p["seconds_clip"])
        fps = g["features"]["sample_rate"] / g["features"]["hop_length"]
        frames = np.clip(np.round(secs * fps), 1, p["t_mel"]).astype(np.int64)
        tokens = np.clip(np.round(frames / fps * p["tokens_per_second"]), 1,
                         p["t_text"]).astype(np.int64)
        order = np.random.default_rng(self.ctx.seed % 2 ** 63).permutation(n)
        return tokens[order], frames[order]

    def make_batches(self, device):
        """The pool, made on the device from the seed in a few large draws."""
        import torch

        p, g = self.p, self.cfg["config"]["generator"]
        b, tt, tm, k = p["batch"], p["t_text"], p["t_mel"], p["pool"]
        hop, seg = g["features"]["hop_length"], min(g["segment_size"], p["t_mel"])
        tokens, frames = self.lengths()
        gen = torch.Generator(device=device)
        gen.manual_seed((self.ctx.seed + 3) % 2 ** 63)
        xl = torch.as_tensor(tokens, device=device).view(k, b)
        ml = torch.as_tensor(frames, device=device).view(k, b)
        x = torch.randint(3, 150, (k, b, tt), generator=gen, device=device)
        x = torch.where(torch.arange(tt, device=device) < xl[..., None], x, 0)
        mel = torch.randn((k, b, g["features"]["n_feats"], tm), generator=gen, device=device)
        pitch = torch.randn((k, b, tm), generator=gen, device=device)
        energy = torch.randn((k, b, tm), generator=gen, device=device)
        wav_seg = 0.1 * torch.randn((k, b, seg * hop), generator=gen, device=device)
        # segment starts as the trainer samples them: in [0, max(len - 4, 1) - seg]
        span = torch.clamp(torch.clamp(ml - 4, min=1) - seg, min=0)
        u = torch.rand((k, b), generator=gen, device=device)
        starts = torch.floor(u * span).to(torch.int32)
        return [{"x": x[i], "x_lengths": xl[i].int(), "mel": mel[i], "mel_lengths": ml[i].int(),
                 "pitches": pitch[i], "energies": energy[i], "wav_seg": wav_seg[i],
                 "start_idx": starts[i]} for i in range(k)]

    # -- set-up ---------------------------------------------------------
    def _reference_models(self):
        import torch

        from harness.common import reference_generator
        from reference.training import Discriminator

        c = self.cfg["config"]
        gen = reference_generator(self.cfg, self.ctx.device)
        with torch.device(self.ctx.device):
            disc = Discriminator(c["discriminator"], c["generator"]["features"])
        return gen, disc

    def setup(self):
        import torch

        from harness.common import program_config
        from harness.weights import init_critics, seeded_state_dict
        from optispeech_tpu_torch.models.discriminator import VocosDiscriminator
        from optispeech_tpu_torch.models.generator import OptiSpeechGenerator
        from optispeech_tpu_torch.training.state import TrainState
        from optispeech_tpu_torch.training.step import make_train_step

        ctx, p = self.ctx, self.p
        dev = ctx.device
        ref_g, ref_d = self._reference_models()
        self.g0 = {k: v.clone() for k, v in seeded_state_dict(ref_g, ctx.seed, dev).items()}
        init_critics(ref_d, ctx.seed + 1, dev)
        self.d0 = {k: v.detach().clone() for k, v in ref_d.state_dict().items()}
        del ref_g, ref_d
        pcfg = program_config(self.cfg)
        dtype = torch.bfloat16 if ctx.control else torch.float32
        gen = OptiSpeechGenerator(pcfg.generator, dtype=dtype)
        gen.load_state_dict(self.g0)
        disc = VocosDiscriminator(pcfg.discriminator, pcfg.generator.features)
        disc.load_state_dict(self.d0)
        self.rng_seed = (ctx.seed + 4) % 2 ** 63
        self.state = TrainState(pcfg, gen.to(dev), disc.to(dev),
                                torch.Generator(device=dev).manual_seed(self.rng_seed))
        self.step = make_train_step(pcfg)
        self.pool = self.make_batches(dev)
        # the compared steps, which are also the warm-up of the window's shapes
        beta1 = pcfg.optimizer.betas[0]
        self.prog = {"g_loss": [], "d_loss": []}
        for i in range(p["compared_steps"]):
            logs = self.step(self.state, self.pool[i])
            self.prog["g_loss"].append(float(logs["total_loss/generator"]))
            self.prog["d_loss"].append(float(logs["total_loss/discriminator"]))
            if i == 0:  # the first gradient as the optimiser took it: m1 = (1 - beta1) g
                self.prog["grad"] = {
                    m: {name: float(o.adamw.state[q]["exp_avg"].norm()) / (1.0 - beta1)
                        if q in o.adamw.state else 0.0 for name, q in module.named_parameters()}
                    for m, module, o in (("g", gen, self.state.g_opt),
                                         ("d", disc, self.state.d_opt))}
        self.prog["change"] = {
            "g": self._changes(self.state.generator, self.g0),
            "d": self._changes(self.state.discriminator, self.d0)}
        self.done = p["compared_steps"]

    @staticmethod
    def _changes(module, start):
        """{name: ||p - p0||} of every parameter."""
        import torch

        with torch.no_grad():
            return {k: float((q - start[k]).norm()) for k, q in module.named_parameters()}

    # -- the window -----------------------------------------------------
    def window(self, seconds):
        import torch

        sync = torch.cuda.synchronize if self.ctx.device != "cpu" else (lambda: None)
        steps = 0
        t0 = time.perf_counter()
        end = t0 + seconds
        while True:
            self.step(self.state, self.pool[self.done % len(self.pool)])
            self.done += 1
            steps += 1
            if time.perf_counter() >= end:
                break
        sync()
        wall = time.perf_counter() - t0
        self.steps = steps
        return {"train_step_ms": 1e3 * wall / steps, "window_s": wall, "steps": steps}

    def counts(self):
        return self.steps, 0

    # -- the traced run -------------------------------------------------
    def traced(self, seconds):
        from harness.trace import profile_window

        def work():
            e2e = self.window(seconds)
            return {"steps": e2e["steps"], "wall_s": e2e["window_s"]}

        data = profile_window(work)
        data.flops = self.step_flops
        return data

    def step_flops(self):
        """FLOPs of one step at the cell's batch: the reference's step
        (forward and backward of G, D's two turns) counted on the first
        `flop_rows` rows of a batch, times batch / flop_rows (every
        product and convolution of the step is per row)."""
        import torch

        from harness.roofline import count_flops
        from reference.training import Optimizer, train_step

        rows = self.p["flop_rows"]
        batch = {k: v[:rows] for k, v in self.pool[0].items()}
        gen, disc = self._replay_models()
        g_opt = Optimizer(gen.parameters(), self.cfg["config"])
        d_opt = Optimizer(disc.parameters(), self.cfg["config"])
        rng = torch.Generator(device=self.ctx.device).manual_seed(self.rng_seed)
        with reference_mode(), torch.enable_grad():
            flops = count_flops(lambda: train_step(gen, disc, g_opt, d_opt, batch, rng,
                                                   self.cfg["config"], backward=True))
        return flops * self.p["batch"] / rows

    # -- after the window -----------------------------------------------
    def free(self):
        del self.state, self.step

    def _replay_models(self):
        gen, disc = self._reference_models()
        gen.load_state_dict(self.g0)
        disc.load_state_dict(self.d0)
        return gen.train(), disc.train()

    def check(self):
        """The reference's first steps from the same weights, batches and
        step RNG, against the program's."""
        import torch

        from harness.compare import checks
        from reference.training import Optimizer, train_step

        gen, disc = self._replay_models()
        g_opt = Optimizer(gen.parameters(), self.cfg["config"])
        d_opt = Optimizer(disc.parameters(), self.cfg["config"])
        rng = torch.Generator(device=self.ctx.device).manual_seed(self.rng_seed)
        ref = {"g_loss": [], "d_loss": []}
        with reference_mode(), torch.enable_grad():
            for i in range(self.p["compared_steps"]):
                g_loss, d_loss, g_grads, d_grads = train_step(
                    gen, disc, g_opt, d_opt, self.pool[i], rng, self.cfg["config"])
                ref["g_loss"].append(float(g_loss))
                ref["d_loss"].append(float(d_loss))
                if i == 0:
                    ref["grad"] = {m: {k: float(t.norm()) for (k, _), t in
                                       zip(module.named_parameters(), grads)}
                                   for m, module, grads in (("g", gen, g_grads),
                                                            ("d", disc, d_grads))}
        ref["change"] = {"g": self._changes(gen, self.g0), "d": self._changes(disc, self.d0)}
        numbers = compare_steps(self.prog, ref, self.p["still_below"], self.ctx.log)
        return numbers, checks(numbers, self.ctx.workload["check"]["limits"])


def _leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """{leaf: |prog - ref| / max(ref, the median leaf's ref)} over `names`;
    a leaf the program lacks reads as not moved."""
    r = np.array([ref[k] for k in names])
    floor = np.median(r)
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], floor) for k in names}


def compare_steps(prog: dict, ref: dict, still_below: float, log=None) -> dict:
    """The compared numbers of a training cell:
    - loss_gap: the worst relative gap of G's and D's loss over the steps;
    - grad_gap: the worst leaf's gap of the first gradient's norm (as the
      optimiser took it, clipped), against the larger of the reference
      leaf's norm and the median leaf's; grad_gap_median: the median leaf's;
    - change_gap: the worst leaf's gap of the parameters' change over the
      steps, over the leaves whose first reference gradient is at least
      `still_below` times the median leaf's (the others move by round-off
      alone)."""
    loss = max(abs(a - b) / abs(b) for k in ("g_loss", "d_loss")
               for a, b in zip(prog[k], ref[k]))
    grads, changes = {}, {}
    for m in ("g", "d"):
        g_ref = ref["grad"][m]
        grads.update({f"{m}/{k}": v for k, v in
                      _leaf_gaps(prog["grad"][m], g_ref, sorted(g_ref)).items()})
        floor = still_below * np.median(list(g_ref.values()))
        moving = sorted(k for k, v in g_ref.items() if v >= floor)
        changes.update({f"{m}/{k}": v for k, v in
                        _leaf_gaps(prog["change"][m], ref["change"][m], moving).items()})
    if log is not None:
        worst = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:4]  # noqa: E731
        log(f"widest leaves: gradient {worst(grads)}; change {worst(changes)}")
    return {"loss_gap": loss, "grad_gap": max(grads.values()),
            "grad_gap_median": float(np.median(list(grads.values()))),
            "change_gap": max(changes.values())}
