"""One rank of the port's data- and tensor-parallel tests on the CPU
(launched by `torch_dist.launch_ranks`; imports the port alone, never JAX).

    python tests/torch_parallel_worker.py step JOB.pt OUT_DIR
    python tests/torch_parallel_worker.py tp JOB.pt OUT_DIR

`step`: the job's G and D weights, `make_train_step(cfg, mesh)` on this
rank's shard (`shard_batch`) of each global batch in turn, the global logs
(`reduce_logs`); writes `rank{r}.pt` with the logs, the parameters after
the steps, the elements of each turn's reduction and (rank 0) the reduced
gradients. `mesh` is "flat" (the
1-D data mesh) or "hybrid" (`make_hybrid_mesh(2)`).

`tp`: the job's G weights in an `OptiSpeech` on the CPU, synthesised
replicated, then with its FFNs split over a (1, world) mesh
(`shard_params_tp`), then so again with the fused blocks asked for (a
sharded block runs unfused); writes `rank{r}.pt` with the three outputs and
what the split did to the FFNs' weights.
"""

import sys
from pathlib import Path

import torch

torch.set_num_threads(1)


def _setup(job):
    from torch_dist import GROUP_TIMEOUT_S

    from optispeech_tpu_torch import config as torch_config
    from optispeech_tpu_torch.parallel import init_distributed

    init_distributed(device="cpu", timeout_s=GROUP_TIMEOUT_S)
    return torch_config.from_dict(torch_config.ExperimentConfig, job["cfg"])


def run_step(job, out_dir: Path):
    import torch.distributed as dist

    from optispeech_tpu_torch.models.discriminator import VocosDiscriminator
    from optispeech_tpu_torch.models.generator import OptiSpeechGenerator
    from optispeech_tpu_torch.parallel import (
        make_hybrid_mesh,
        make_mesh,
        reduce_logs,
        replicate_state,
        shard_batch,
    )
    from optispeech_tpu_torch.parallel.mesh import all_reduce_grads
    from optispeech_tpu_torch.training import step as step_module
    from optispeech_tpu_torch.training.state import TrainState

    cfg = _setup(job)
    mesh = make_hybrid_mesh(2) if job["mesh"] == "hybrid" else make_mesh(cfg.num_devices)
    gen = OptiSpeechGenerator(cfg.generator)
    gen.load_state_dict(job["g"])
    disc = VocosDiscriminator(cfg.discriminator, cfg.generator.features)
    disc.load_state_dict(job["d"])
    state = replicate_state(TrainState(cfg, gen, disc, torch.Generator().manual_seed(0)), mesh)
    sizes, reduced = [], []

    def counting(grads, m):  # each turn's reduction: its elements, and rank 0's result
        sizes.append(sum(g.numel() for g in grads if g is not None))
        out = all_reduce_grads(grads, m)
        if dist.get_rank() == 0:
            reduced.append([None if g is None else g.clone() for g in out])
        return out

    step_module.all_reduce_grads = counting
    step = step_module.make_train_step(cfg, mesh)
    logs, shards = [], []
    for batch in job["batches"]:
        local = shard_batch({k: torch.as_tensor(v) for k, v in batch.items()}, mesh)
        shards.append({k: v.clone() for k, v in local.items()})
        logs.append({k: float(v) for k, v in reduce_logs(step(state, local), mesh).items()})
    torch.save({"rank": dist.get_rank(), "logs": logs, "shards": shards, "reduced": sizes,
                "grads": reduced,
                "g": state.generator.state_dict(), "d": state.discriminator.state_dict()},
               out_dir / f"rank{dist.get_rank()}.pt")
    dist.destroy_process_group()


def run_tp(job, out_dir: Path):
    import torch.distributed as dist

    from optispeech_tpu_torch.models.optispeech import OptiSpeech
    from optispeech_tpu_torch.parallel import make_2d_mesh, replicate_tp, shard_params_tp
    from optispeech_tpu_torch.parallel.tp import is_sharded
    from optispeech_tpu_torch.values import InferenceInputs

    cfg = _setup(job)
    model = OptiSpeech(cfg, device="cpu", state_dict=job["g"])
    inputs = InferenceInputs(clean_text="", x=job["x"], x_lengths=job["x_lengths"],
                             d_factor=job["d_factor"])

    def synth():
        out = model.synthesise_on_device(inputs, n_frames=job["n_frames"])
        return {k: out[k].detach().clone() for k in ("wav", "durations")}

    replicated = synth()
    mesh = make_2d_mesh(1, dist.get_world_size())
    replicate_tp(model.generator, mesh)
    shard_params_tp(model.generator, mesh)
    split = {name: (tuple(p.shape), tuple(p.to_local().shape), str(p.placements))
             for name, p in model.generator.named_parameters() if is_sharded(p)}
    sharded = synth()
    for stack in (model.generator.decoder, model.generator.vocoder):
        stack.fused_pallas = True  # a sharded block runs unfused all the same
    fused_asked = synth()
    torch.save({"replicated": replicated, "sharded": sharded, "fused_asked": fused_asked,
                "split": split}, out_dir / f"rank{dist.get_rank()}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    kind, job_path, out = sys.argv[1:4]
    job = torch.load(job_path, weights_only=False)
    {"step": run_step, "tp": run_tp}[kind](job, Path(out))
