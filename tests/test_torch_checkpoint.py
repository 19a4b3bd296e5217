"""Port parity for the training checkpoint: ``distributed/checkpoint``
(save/load in JAX's on-disk format, the atomic step dirs, the verified
``load_latest``, ``AsyncCheckpointer``) and ``fleet/preemption``, after
``tests/test_checkpoint.py``'s one-device cases, on CPU tensors; the two
formats across the packages; and the whole slice (remat ``partial:1``,
``TrainLoop``, ``prefetch_to_device``, async saves) against the JAX
hybrid step.

Tolerances: every checkpoint round trip, and every load across the two
packages, is bit for bit (bfloat16 included).  Losses of the slice
against the JAX step at rel 1e-4 (``test_torch_train.py::
test_train_steps_match_jax``'s bar); a resumed port run against the
uninterrupted one bit for bit.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from paddle_tpu.core.tensor import Tensor
from paddle_tpu.distributed import checkpoint as jcp
from paddle_tpu.distributed import hybrid as jhybrid
from paddle_tpu.distributed.process_mesh import ProcessMesh
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch.distributed import checkpoint as dist_cp
from paddle_tpu_torch.distributed.checkpoint.load_state_dict import \
    read_metadata
from paddle_tpu_torch.distributed import hybrid as thybrid
from paddle_tpu_torch.distributed.fleet.preemption import (MARKER,
                                                           PreemptionGuard,
                                                           resume_step)
from paddle_tpu_torch.io import prefetch_to_device
from paddle_tpu_torch.jit.loop import TrainLoop
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.testing import faults


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_roundtrip_same_sharding(tmp_path):
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    dist_cp.save_state_dict({"w": _t(w)}, str(tmp_path))
    sd = {"w": torch.zeros(8, 8)}
    dist_cp.load_state_dict(sd, str(tmp_path))
    np.testing.assert_array_equal(sd["w"].numpy(), w)


def test_nested_state_dict_and_dtype_cast(tmp_path):
    r = np.random.RandomState(0)
    w, m = r.rand(8, 4).astype(np.float32), r.rand(8, 4).astype(np.float32)
    dist_cp.save_state_dict({"model": {"w": _t(w)}, "opt": {"moment1": _t(m)},
                             "step": torch.tensor(7, dtype=torch.int32)},
                            str(tmp_path))
    tgt = {"model": {"w": torch.zeros(8, 4)},
           "opt": {"moment1": torch.zeros(8, 4, dtype=torch.float64)},
           "step": torch.tensor(0, dtype=torch.int64)}
    dist_cp.load_state_dict(tgt, str(tmp_path))
    np.testing.assert_array_equal(tgt["model"]["w"].numpy(), w)
    # float32 saved, float64 target: cast (exactly, here)
    np.testing.assert_array_equal(tgt["opt"]["moment1"].numpy(), m)
    assert tgt["step"].dtype == torch.int64 and int(tgt["step"]) == 7


def test_bfloat16_roundtrip(tmp_path):
    w = torch.from_numpy(np.random.rand(8, 8).astype(np.float32)).bfloat16()
    dist_cp.save_state_dict({"w": w}, str(tmp_path))
    sd = {"w": torch.zeros(8, 8, dtype=torch.bfloat16)}
    dist_cp.load_state_dict(sd, str(tmp_path))
    assert torch.equal(sd["w"].view(torch.int16), w.view(torch.int16))


def test_async_save(tmp_path):
    w = np.random.rand(8, 4).astype(np.float32)
    dist_cp.save_state_dict({"w": _t(w)}, str(tmp_path), async_save=True)
    dist_cp.wait_async_save()
    sd = {"w": torch.zeros(8, 4)}
    dist_cp.load_state_dict(sd, str(tmp_path))
    np.testing.assert_array_equal(sd["w"].numpy(), w)


def test_async_save_copies_before_returning(tmp_path):
    """The shard is pickled from the tensors' memory, so an async save
    takes its copy first: a change after the call is not saved."""
    w = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    want = w.clone()
    from paddle_tpu_torch.testing.faults import inject_io
    with inject_io(slow_write=0.05):
        dist_cp.save_state_dict({"w": w}, str(tmp_path), async_save=True)
        w.zero_()
        dist_cp.wait_async_save()
    sd = {"w": torch.zeros(8, 4)}
    dist_cp.load_state_dict(sd, str(tmp_path))
    assert torch.equal(sd["w"], want)


def test_shard_file_is_the_pickle_of_its_bytes(tmp_path):
    """The shard file, streamed from the tensors' memory, is byte for
    byte ``pickle.dumps`` (protocol 4) of JAX's record with ``bytes``
    values: short (<= 255 B), framed and large (>= 64 KiB) bytes, bf16
    words, a 0-d tensor and a bool one."""
    import pickle
    g = torch.Generator().manual_seed(3)
    state = {"a": torch.randn(3, generator=g),
             "b": torch.randn(40, 50, generator=g),
             "c": torch.randn(300, 257, generator=g).bfloat16(),
             "d": torch.tensor(7),
             "e": torch.rand(5, 9, generator=g) > 0.5,
             "f": torch.randn(1 << 16, generator=g)}
    dist_cp.save_state_dict(state, str(tmp_path))
    want = {}
    for k, t in state.items():
        raw = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        want[(k, (0,) * t.dim())] = {
            "bytes": raw.numpy().tobytes(),
            "dtype": str(t.dtype).replace("torch.", ""),
            "shape": tuple(t.shape)}
    with open(tmp_path / "0_0.distcp", "rb") as f:
        assert f.read() == pickle.dumps(want, protocol=4)


@pytest.mark.parametrize("pieces", [[0], [5], [1 << 20], [(1 << 20) + 3],
                                    [7, 1 << 20, 11, (3 << 20) + 5, 1, 0]])
def test_chunk_writer_cuts_a_whole_blob_s_chunks(tmp_path, pieces):
    """A file written in pieces reaches the IO layer's ``_write`` in
    the chunks ``write_file`` cuts the whole blob into, and is counted
    and hashed whole."""
    import hashlib
    from paddle_tpu_torch.distributed.checkpoint import _io

    class Recording(_io.CheckpointIO):
        def __init__(self):
            self.chunks = []

        def _write(self, f, chunk):
            self.chunks.append(bytes(chunk))
            f.write(chunk)
    rng = np.random.default_rng(len(pieces))
    blobs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
             for n in pieces]
    whole, parts = Recording(), Recording()
    whole.write_file(str(tmp_path / "whole"), b"".join(blobs))
    with parts.staged(str(tmp_path / "parts")) as w:
        for b in blobs:
            w.write(b)
    assert parts.chunks == whole.chunks
    assert (tmp_path / "parts").read_bytes() == b"".join(blobs)
    assert w.digest() == {"bytes": sum(pieces), "sha256": hashlib.sha256(
        b"".join(blobs)).hexdigest()}


def test_missing_key_raises(tmp_path):
    dist_cp.save_state_dict({"a": torch.zeros(4, 4)}, str(tmp_path))
    with pytest.raises(KeyError):
        dist_cp.load_state_dict({"b": torch.zeros(4, 4)}, str(tmp_path))


def test_shape_mismatch_raises(tmp_path):
    dist_cp.save_state_dict({"a": torch.zeros(4, 4)}, str(tmp_path))
    with pytest.raises(ValueError):
        dist_cp.load_state_dict({"a": torch.zeros(8, 4)}, str(tmp_path))


def test_load_in_place_keeps_the_tensor(tmp_path):
    """The load writes into the given tensor (a trainable leaf too)."""
    w = torch.randn(4, 4)
    dist_cp.save_state_dict({"w": w}, str(tmp_path))
    target = torch.zeros(4, 4, requires_grad=True)
    sd = {"w": target}
    dist_cp.load_state_dict(sd, str(tmp_path))
    assert sd["w"] is target and torch.equal(target.detach(), w)


# ---------------------------------------------------------------------------
# The crash-safe layer (after tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

def _step_state(seed):
    r = np.random.RandomState(seed)
    return {"w": _t(r.rand(8, 8).astype(np.float32)),
            "opt": {"m": _t(r.rand(8, 4).astype(np.float32))}}


def _assert_state_is(sd, seed):
    r = np.random.RandomState(seed)
    np.testing.assert_array_equal(sd["w"].numpy(),
                                  r.rand(8, 8).astype(np.float32))
    np.testing.assert_array_equal(sd["opt"]["m"].numpy(),
                                  r.rand(8, 4).astype(np.float32))


class TestAtomicCommit:
    def test_save_writes_manifest_and_verifies(self, tmp_path):
        d = dist_cp.save_checkpoint(_step_state(1), str(tmp_path), 1)
        assert os.path.isfile(os.path.join(d, dist_cp.MANIFEST_FILE))
        ok, problems = dist_cp.verify_checkpoint(d)
        assert ok, problems
        assert dist_cp.list_steps(str(tmp_path)) == [1]
        assert dist_cp.latest_pointer(str(tmp_path)) == 1

    def test_crash_mid_shard_leaves_previous_intact(self, tmp_path):
        root = str(tmp_path)
        dist_cp.save_checkpoint(_step_state(1), root, 1)
        dist_cp.save_checkpoint(_step_state(2), root, 2)
        with pytest.raises(faults.FaultInjected):
            with faults.inject_io(crash_at_write=1, match=".distcp"):
                dist_cp.save_checkpoint(_step_state(3), root, 3)
        assert dist_cp.list_steps(root) == [1, 2]
        sd = _step_state(0)
        assert dist_cp.load_latest(sd, root) == 2
        _assert_state_is(sd, 2)

    def test_crash_during_manifest_never_commits(self, tmp_path):
        root = str(tmp_path)
        dist_cp.save_checkpoint(_step_state(1), root, 1)
        with pytest.raises(faults.FaultInjected):
            with faults.inject_io(crash_at_write=1, match="manifest"):
                dist_cp.save_checkpoint(_step_state(2), root, 2)
        sd = _step_state(0)
        assert dist_cp.load_latest(sd, root) == 1
        _assert_state_is(sd, 1)

    def test_flipped_byte_detected_and_quarantined(self, tmp_path):
        root = str(tmp_path)
        dist_cp.save_checkpoint(_step_state(1), root, 1)
        d2 = dist_cp.save_checkpoint(_step_state(2), root, 2)
        shard = os.path.join(d2, "0_0.distcp")
        raw = bytearray(open(shard, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(shard, "wb").write(bytes(raw))
        with pytest.raises(dist_cp.CheckpointCorruptError):
            dist_cp.load_state_dict(_step_state(0), d2)
        sd = _step_state(0)
        assert dist_cp.load_latest(sd, root) == 1
        _assert_state_is(sd, 1)
        assert dist_cp.list_steps(root) == [1]
        assert any(n.startswith(".corrupt-step_") for n in os.listdir(root))

    def test_truncated_shard_detected(self, tmp_path):
        root = str(tmp_path)
        dist_cp.save_checkpoint(_step_state(1), root, 1)
        with faults.inject_io(truncate_at_write=1, match=".distcp") as io:
            dist_cp.save_checkpoint(_step_state(2), root, 2)
        assert io.injected >= 1
        sd = _step_state(0)
        assert dist_cp.load_latest(sd, root) == 1
        _assert_state_is(sd, 1)

    def test_retention_keeps_last_n_verified(self, tmp_path):
        root = str(tmp_path)
        for s in range(1, 6):
            dist_cp.save_checkpoint(_step_state(s), root, s, keep_last_n=2)
        assert dist_cp.list_steps(root) == [4, 5]
        shard = os.path.join(dist_cp.step_dir(root, 5), "0_0.distcp")
        open(shard, "ab").write(b"garbage")
        dist_cp.apply_retention(root, 1)
        assert 4 in dist_cp.list_steps(root)
        sd = _step_state(0)
        assert dist_cp.load_latest(sd, root) == 4
        _assert_state_is(sd, 4)

    def test_load_latest_empty_root(self, tmp_path):
        assert dist_cp.load_latest(None, str(tmp_path)) is None
        assert dist_cp.load_latest(None,
                                   str(tmp_path / "nonexistent")) is None


class TestAsyncCheckpointer:
    def test_background_saves_commit_and_drain(self, tmp_path):
        root = str(tmp_path)
        with dist_cp.AsyncCheckpointer(root, keep_last_n=3) as ac:
            for s in range(1, 5):
                ac.save(_step_state(s), s)
            ac.drain()
            assert dist_cp.list_steps(root) == [2, 3, 4]
            assert ac.save_lag() == 0.0 and ac.stats["commits"] == 4
        sd = _step_state(0)
        assert dist_cp.load_latest(sd, root) == 4
        _assert_state_is(sd, 4)

    def test_worker_failure_surfaces_on_drain(self, tmp_path):
        root = str(tmp_path)
        ac = dist_cp.AsyncCheckpointer(root)
        try:
            with faults.inject_io(crash_at_write=1, match=".distcp"):
                ac.save(_step_state(1), 1)
                with pytest.raises(faults.FaultInjected):
                    ac.drain()
        finally:
            ac._stop.set()
        assert dist_cp.load_latest(None, root) is None

    def test_commit_deadline_watchdog(self, tmp_path):
        root = str(tmp_path)
        ac = dist_cp.AsyncCheckpointer(root, commit_timeout=0.01)
        try:
            with faults.inject_io(slow_write=0.05):
                ac.save(_step_state(1), 1)
                with pytest.raises(TimeoutError):
                    ac.drain()
        finally:
            ac._stop.set()

    def test_snapshot_is_a_copy(self, tmp_path):
        """The port's step updates the state in place: a save is a copy
        taken at save(), not a reference."""
        root = str(tmp_path)
        state = _step_state(5)
        with dist_cp.AsyncCheckpointer(root) as ac:
            with faults.inject_io(slow_write=0.02):
                ac.save(state, 5)
                state["w"].zero_()
                state["opt"]["m"].fill_(3.0)
                ac.drain()
        sd = _step_state(0)
        assert dist_cp.load_latest(sd, root) == 5
        _assert_state_is(sd, 5)

    def test_commit_spans_split_each_commit(self, tmp_path):
        """Every commit leaves its parts in ``spans``: the copies' wait,
        pack, write (pickle, hash and fsync) and metadata in that order,
        each inside the whole commit."""
        parts = ["wait", "pack", "write", "metadata"]
        with dist_cp.AsyncCheckpointer(str(tmp_path)) as ac:
            for s in (1, 2):
                ac.save(_step_state(s), s)
            ac.drain()
        for s in (1, 2):
            got = [x for x in ac.spans if x[0] == s]
            assert [x[1] for x in got] == parts + ["commit"]
            _, _, c0, c1 = got[-1]
            ends = [x[3] for x in got[:-1]]
            assert all(c0 <= x[2] <= x[3] <= c1 for x in got[:-1])
            assert ends == sorted(ends)


class TestRetentionVsInflightSave:
    def test_retention_never_deletes_step_being_committed(self, tmp_path):
        root = str(tmp_path)
        for s in (1, 2):
            dist_cp.save_checkpoint(_step_state(s), root, s)
        ac = dist_cp.AsyncCheckpointer(root)
        try:
            with faults.inject_io(slow_write=0.02):
                ac.save(_step_state(3), 3)
                deleted = dist_cp.apply_retention(root, keep_last_n=1)
                assert 3 not in deleted
            ac.drain()
        finally:
            ac._stop.set()
        steps = dist_cp.list_steps(root)
        assert 3 in steps and 1 not in steps
        sd = _step_state(0)
        assert dist_cp.load_latest(sd, root) == 3
        _assert_state_is(sd, 3)

    def test_find_latest_verified_quarantines_uncommitted_dir(self, tmp_path):
        root = str(tmp_path)
        dist_cp.save_checkpoint(_step_state(4), root, 4)
        bad = dist_cp.step_dir(root, 9)
        os.makedirs(bad)
        with open(os.path.join(bad, "0_0.distcp"), "wb") as f:
            f.write(b"half-written shard bytes")
        assert dist_cp.find_latest_verified(root) == (
            4, dist_cp.step_dir(root, 4))
        assert dist_cp.list_steps(root) == [4]
        assert len([n for n in os.listdir(root)
                    if n.startswith(".corrupt-step_00000009")]) == 1


class TestPreemptionIntegration:
    def test_guard_drains_async_and_exits_143(self, tmp_path):
        async_root = str(tmp_path / "async")
        final = str(tmp_path / "final")
        ac = dist_cp.AsyncCheckpointer(async_root)
        guard = PreemptionGuard(checkpointer=ac)
        try:
            ac.save(_step_state(7), 7)
            with pytest.raises(SystemExit) as ei:
                guard.checkpoint_and_exit(_step_state(9), final, step=9)
            assert ei.value.code == 143
        finally:
            guard.restore()
            ac._stop.set()
        assert dist_cp.load_latest(None, async_root) == 7
        assert resume_step(final) == 9
        sd = _step_state(0)
        dist_cp.load_state_dict(sd, final)
        _assert_state_is(sd, 9)

    def test_resume_step_refuses_corrupt_checkpoint(self, tmp_path):
        path = str(tmp_path)
        dist_cp.save_state_dict(_step_state(1), path)
        with open(os.path.join(path, MARKER), "w") as f:
            json.dump({"step": 5}, f)
        assert resume_step(path) == 5
        shard = os.path.join(path, "0_0.distcp")
        raw = bytearray(open(shard, "rb").read())
        raw[10] ^= 0xFF
        open(shard, "wb").write(bytes(raw))
        assert resume_step(path) is None

    def test_failed_final_save_exits_143_without_marker(self, tmp_path):
        final = str(tmp_path / "final")
        guard = PreemptionGuard()
        try:
            with faults.inject_io(crash_at_write=1, match=".distcp"):
                with pytest.raises(SystemExit) as ei:
                    guard.checkpoint_and_exit(_step_state(3), final, step=3)
            assert ei.value.code == 143
        finally:
            guard.restore()
        assert not os.path.exists(os.path.join(final, MARKER))
        assert resume_step(final) is None


# ---------------------------------------------------------------------------
# Across the packages: JAX's files in the port, the port's in JAX
# ---------------------------------------------------------------------------

def test_jax_mesh_checkpoint_loads_into_the_port(tmp_path):
    """JAX's save_checkpoint on the 8-device virtual mesh, with dp- and
    mp-sharded arrays (several shards a tensor) and bfloat16, loads into
    the port's one-device tensors bit for bit."""
    mesh = ProcessMesh(np.arange(8).reshape(2, 4), ["dp", "mp"])
    r = np.random.RandomState(3)
    w = r.standard_normal((8, 12)).astype(np.float32)
    e = r.standard_normal((16, 8)).astype(np.float32)
    b = r.standard_normal((4, 8)).astype(np.float32)

    def put(x, spec, dt=jnp.float32):
        return Tensor(jax.device_put(jnp.asarray(x, dt), NamedSharding(
            mesh.jax_mesh, spec)))
    state = {"params": {"w": put(w, P("dp", "mp")), "e": put(e, P("mp")),
                        "b": put(b, P(None, "dp"), jnp.bfloat16)},
             "opt": {"step": put(np.int32(6), P())}}
    jcp.save_checkpoint(state, str(tmp_path), 6)
    meta = read_metadata(dist_cp.step_dir(str(tmp_path), 6))
    assert len(meta.state_dict_metadata["params.w"]) == 8
    tgt = {"params": {"w": torch.zeros(8, 12), "e": torch.zeros(16, 8),
                      "b": torch.zeros(4, 8, dtype=torch.bfloat16)},
           "opt": {"step": torch.tensor(0, dtype=torch.int64)}}
    assert dist_cp.load_latest(tgt, str(tmp_path)) == 6
    np.testing.assert_array_equal(tgt["params"]["w"].numpy(), w)
    np.testing.assert_array_equal(tgt["params"]["e"].numpy(), e)
    want_b = np.asarray(jnp.asarray(b, jnp.bfloat16)).view(np.int16)
    np.testing.assert_array_equal(
        tgt["params"]["b"].view(torch.int16).numpy(), want_b)
    assert int(tgt["opt"]["step"]) == 6


def test_port_checkpoint_loads_in_jax(tmp_path):
    """A checkpoint the port writes loads in JAX's load_state_dict (its
    manifest verified, its metadata unpickled into JAX's classes) bit
    for bit, bfloat16 included, onto a sharded target."""
    r = np.random.RandomState(4)
    w = r.standard_normal((8, 12)).astype(np.float32)
    b = torch.from_numpy(r.standard_normal((4, 8)).astype(np.float32)
                         ).bfloat16()
    dist_cp.save_checkpoint({"params": {"w": _t(w), "b": b},
                             "step": torch.tensor(3)}, str(tmp_path), 3)
    mesh = ProcessMesh(np.arange(8).reshape(2, 4), ["dp", "mp"])

    def put(x, spec, dt):
        return Tensor(jax.device_put(jnp.zeros(x, dt), NamedSharding(
            mesh.jax_mesh, spec)))
    tgt = {"params": {"w": put((8, 12), P("dp", "mp"), jnp.float32),
                      "b": put((4, 8), P(), jnp.bfloat16)},
           "step": put((), P(), jnp.int32)}
    assert jcp.load_latest(tgt, str(tmp_path)) == 3
    np.testing.assert_array_equal(np.asarray(tgt["params"]["w"]._data), w)
    np.testing.assert_array_equal(
        np.asarray(tgt["params"]["b"]._data).view(np.int16),
        b.view(torch.int16).numpy())
    assert int(np.asarray(tgt["step"]._data)) == 3


def test_opt_state_from_numpy_matches_jax_layout():
    """The JAX step's AdamW state as numpy -> the port's {m, v, step}."""
    p = {"a": np.ones((2, 3), np.float32), "b": {"c": np.zeros(4, np.float32)}}
    js = jhybrid.adamw_init(jax.tree_util.tree_map(jnp.asarray, p))
    js["step"] = js["step"] + 5
    ts = thybrid.opt_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, js), device="cpu")
    assert ts["step"].dtype == torch.int64 and int(ts["step"]) == 5
    assert ts["m"]["b"]["c"].shape == (4,) and ts["v"]["a"].dtype == \
        torch.float32
    ref = thybrid.adamw_init(tgpt.params_from_numpy(p, device="cpu"))
    assert set(ts) == set(ref)


# ---------------------------------------------------------------------------
# The whole slice
# ---------------------------------------------------------------------------

SLICE_STEPS = 6


def _batches(cfg, seed, start=0, n=SLICE_STEPS, B=4, S=32):
    """The seeded host loader: batch i made from seed + i."""
    for i in range(start, n):
        rng = np.random.default_rng(seed + i)
        yield (rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64),
               rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64))


def _port_run(tree, root, start=0, resume=None):
    """gpt_tiny, remat partial:1, TrainLoop over prefetch_to_device with
    an AsyncCheckpointer every 2 steps; ``resume`` loads that root's
    latest verified step first.  Returns (losses, state)."""
    cfg = tgpt.gpt_tiny()
    step, shard, init_opt = thybrid.build_train_step(
        cfg, remat="partial:1", device="cpu")
    params = shard(tgpt.params_from_numpy(tree, device="cpu"))
    state = {"params": params, "opt": init_opt(params)}
    if resume is not None:
        start = dist_cp.load_latest(state, resume)
    losses = []
    with dist_cp.AsyncCheckpointer(root) as ac, \
            TrainLoop(step, max_inflight=2) as loop:
        for i, (ids, lab) in enumerate(prefetch_to_device(
                _batches(cfg, 0, start), device=step.data_device),
                start=start + 1):
            d, _, _ = loop.step(state["params"], state["opt"], ids, lab)
            losses.append(d)
            if i % 2 == 0:
                ac.save(state, i)
        loop.drain()
    return [float(d) for d in losses], state


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    tree = jax.tree_util.tree_map(np.asarray, tgpt.init_params(
        tgpt.gpt_tiny(), seed=0, device="cpu"))
    root = str(tmp_path_factory.mktemp("slice"))
    losses, state = _port_run(tree, root)
    return tree, root, losses, state


def _jax_step():
    cfg = jgpt.gpt_tiny(unroll_layers=False)
    mesh = ProcessMesh(np.arange(1).reshape(1, 1, 1), ["dp", "pp", "mp"])
    return cfg, mesh, jhybrid.build_train_step(
        cfg, mesh, num_micro=1, remat="partial:1", zero=0)


def test_slice_matches_jax_and_resumes_bit_for_bit(slice_runs,
                                                   tmp_path):
    """Six steps of the slice against the JAX hybrid step (rel 1e-4);
    a resume from the step-4 checkpoint gives the uninterrupted run's
    losses 5-6 and final state bit for bit."""
    tree, root, losses, state = slice_runs
    assert dist_cp.list_steps(root) == [2, 4, 6]
    cfg, _, (jstep, jshard, jinit) = _jax_step()
    jp = jshard(jax.tree_util.tree_map(jnp.asarray, tree))
    jo = jinit(jp)
    jl = []
    for ids, lab in _batches(cfg, 0):
        loss, jp, jo = jstep(jp, jo, jnp.asarray(ids, jnp.int32),
                             jnp.asarray(lab, jnp.int32))
        jl.append(float(loss))
    np.testing.assert_allclose(losses, jl, rtol=1e-4)
    # drop step 6, so the resume starts from step 4
    dist_cp.quarantine(root, 6)
    resumed, rstate = _port_run(tree, str(tmp_path), resume=root)
    assert resumed == losses[4:]
    for (name, a), (_, b) in zip(
            sorted(dist_cp.flatten_state_dict(state)[0].items()),
            sorted(dist_cp.flatten_state_dict(rstate)[0].items())):
        assert torch.equal(a, b), name


def test_jax_checkpoint_resumes_in_the_port(slice_runs, tmp_path):
    """JAX's step-2 checkpoint (params and AdamW state, written by its
    save_checkpoint) resumes in the port, whose steps 3-6 match JAX's at
    rel 1e-4."""
    tree = slice_runs[0]
    cfg, _, (jstep, jshard, jinit) = _jax_step()
    jp = jshard(jax.tree_util.tree_map(jnp.asarray, tree))
    jo = jinit(jp)
    jl = []
    for i, (ids, lab) in enumerate(_batches(cfg, 0), start=1):
        loss, jp, jo = jstep(jp, jo, jnp.asarray(ids, jnp.int32),
                             jnp.asarray(lab, jnp.int32))
        jl.append(float(loss))
        if i == 2:
            jcp.save_checkpoint({"params": jp, "opt": jo},
                                str(tmp_path / "jax"), 2)
    resumed, _ = _port_run(tree, str(tmp_path / "port"),
                           resume=str(tmp_path / "jax"))
    np.testing.assert_allclose(resumed, jl[2:], rtol=1e-4)
