"""The port's process-group and mesh helpers (`parallel/mesh.py`,
`parallel/tp.py`) in one process: what raises without a launcher's
environment, JAX's messages for a mesh that does not fit, a one-rank gloo
group (world 1: the step's shares and reductions are the identity), and the
tensor-parallel name rule against JAX's."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from optispeech_tpu.parallel.tp import _spec_for
from optispeech_tpu_torch import parallel
from optispeech_tpu_torch.parallel.mesh import LAUNCH_ENV
from optispeech_tpu_torch.parallel.tp import split_of
from torch_dist import free_port

torch.set_num_threads(1)


def test_init_distributed_needs_the_launchers_environment(monkeypatch):
    for name in LAUNCH_ENV:
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed.run --standalone"):
        parallel.init_distributed(device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        parallel.make_mesh()


@pytest.fixture(scope="module")
def one_rank():
    """A gloo group of one rank, left when the module's tests are done."""
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(free_port()))
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        with pytest.raises(ValueError, match="only gloo runs there"):
            parallel.init_distributed(device="cpu", backend="nccl")
        assert parallel.init_distributed(device="cpu", timeout_s=60) == torch.device("cpu")
        assert dist.get_backend() == "gloo"
        yield
    dist.destroy_process_group()


def test_meshes_that_do_not_fit_raise_as_in_jax(one_rank):
    with pytest.raises(ValueError, match="num_devices=2 but the group has 1 ranks"):
        parallel.make_mesh(2)
    with pytest.raises(ValueError, match="1 devices not divisible by 2 slices"):
        parallel.make_hybrid_mesh(2)
    with pytest.raises(ValueError, match="a 1 x 2 mesh needs 2 ranks"):
        parallel.make_2d_mesh(1, 2)
    mesh = parallel.make_mesh(1)
    assert mesh.mesh_dim_names == ("data",)
    assert parallel.data_size(mesh) == 1 and parallel.data_rank(mesh) == 0
    hybrid = parallel.make_hybrid_mesh(1)
    assert hybrid.mesh_dim_names == ("dcn_data", "data") and parallel.data_size(hybrid) == 1


def test_one_rank_reductions_are_the_identity(one_rank):
    mesh = parallel.make_mesh()
    grads = [torch.randn(3, 4), None, torch.randn(5), torch.randn(2, dtype=torch.float64)]
    reduced = parallel.all_reduce_grads(grads, mesh)
    assert reduced[1] is None
    for g, r in zip(grads, reduced):
        assert g is None or (torch.equal(g, r) and r.dtype == g.dtype and r.shape == g.shape)
    logs = {"total_loss/generator": torch.tensor(2.5), "grad_norm/generator": torch.tensor(7.0)}
    assert {k: float(v) for k, v in parallel.reduce_logs(logs, mesh).items()} == {
        "total_loss/generator": 2.5, "grad_norm/generator": 7.0}
    batch = {"x": np.arange(6).reshape(3, 2), "sids": None, "texts": ["a", "b", "c"]}
    sharded = parallel.shard_batch(batch, mesh)
    assert sharded["sids"] is None and sharded["texts"] == batch["texts"]
    np.testing.assert_array_equal(sharded["x"], batch["x"])


def test_trainer_takes_num_devices_equal_to_the_world(one_rank, tmp_path):
    import dataclasses

    from optispeech_tpu_torch.training import loggers
    from optispeech_tpu_torch.training.trainer import Trainer
    from test_torch_trainer import tiny_config

    mesh = parallel.make_mesh()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(loggers._SINK_REGISTRY, "tensorboard", lambda *args: None)
        t = Trainer(tiny_config(num_devices=1), out_dir=str(tmp_path), device="cpu", mesh=mesh)
        assert (t.rank, t.world, t.is_main) == (0, 1, True)
        with pytest.raises(ValueError, match="num_devices=2 but the mesh has 1 ranks"):
            Trainer(tiny_config(num_devices=2), out_dir=str(tmp_path), device="cpu", mesh=mesh)
        cfg = dataclasses.replace(tiny_config(), num_devices=None)
        assert Trainer(cfg, out_dir=str(tmp_path), device="cpu", mesh=mesh).world == 1


@pytest.mark.parametrize("name,jax_path,split", [
    ("decoder.convnext.0.pwconv1", ("decoder", "block_0", "pwconv1", "kernel"), "column"),
    ("vocoder.backbone.convnext.3.pwconv2", ("vocoder", "backbone", "block_3", "pwconv2",
                                             "kernel"), "row"),
    ("vocoder.head.linear_1", ("vocoder", "linear_1", "kernel"), "column"),
    ("vocoder.head.linear_2", ("vocoder", "linear_2", "kernel"), "row"),
    ("encoder.transformer.encoders.1.feed_forward.w_1",
     ("encoder", "layer_1", "feed_forward", "w_1", "kernel"), "column"),
    ("encoder.conformer.encoders.0.feed_forward_macaron.w_2",
     ("encoder", "layer_0", "feed_forward_macaron", "w_2", "kernel"), "row"),
    ("decoder.convnext.0.dwconv", ("decoder", "block_0", "dwconv", "kernel"), None),
    ("encoder.transformer.encoders.1.self_attn.linear_q",
     ("encoder", "layer_1", "self_attn", "linear_q", "kernel"), None)])
def test_split_rule_is_jaxs(name, jax_path, split):
    """The port's rule on its module names gives the split JAX's `_spec_for`
    gives the same layer's kernel (columns: its last axis, rows: its first)."""
    class Key:
        def __init__(self, key):
            self.key = key

    spec = _spec_for(tuple(Key(k) for k in jax_path), np.zeros((3, 4)))
    want = "column" if tuple(spec) == (None, "model") else "row" if tuple(spec) == (
        "model", None) else None
    assert split_of(name) == split == want
