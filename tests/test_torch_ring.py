"""Port parity for context parallelism: ``flash_attention_with_lse`` (the
ring variant of flash attention), ``ring_attention`` over a
``torch.distributed`` group, and ``llama.loss_fn(sp_group=...)``,
against the JAX package.

* ``flash_attention_with_lse`` on CPU tensors (the plain forward and
  backward) against JAX's in Pallas interpret mode at [BH 4, S 128,
  D 64] float32, offsets -128 (every row fully masked), -37, 0, 37 and
  128: out and lse within 1e-5 (lse of fully masked rows -1e30 on both
  sides), and dq/dk/dv from the cotangents (g_out, g_lse), g_lse
  nonzero, within 1e-5 of each gradient's largest value.
* The ring over 4 gloo ranks against ``shard_map(ring_attention)`` on a
  4-device CPU mesh: out and the input gradients within 1e-5 of their
  largest value; and the same 4 ranks replayed in one process through
  ``ring_attention_loop`` with a local hand-over, within 1e-6.
* ``llama.loss_fn(sp_group=g)`` over 4 gloo ranks against JAX's
  ``sp_axis`` loss (rtol 2e-4) and against the per-rank gradients
  combined as JAX's test combines them (the mean over the group; gloo
  has no AVG, so SUM then / 4) at rtol 5e-3, atol 5e-5, the limits of
  ``tests/test_watchdog_sp.py``; llama_tiny built as that file builds it,
  and once more with 2 KV heads (GQA).

The ranks run in processes spawned once for the module
(``torch.multiprocessing``, start method spawn); they re-import this
file, so it imports JAX only inside fixtures and test bodies, and they
meet through a ``FileStore`` in a temporary directory.  Each rank
computes every result once and writes it to an ``.npz`` file.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from paddle_tpu_torch.incubate.nn.kernels import flash_attention as tfa
from paddle_tpu_torch.incubate.nn.kernels import ring_attention as tra
from paddle_tpu_torch.models import llama as tl

P = 4                                  # ranks of the ring
RING_SHAPE = (2, P * 48, 2, 32)        # B, S (48 a rank), nH, hD
# (name, llama_tiny overrides, ids shape, seed): test_watchdog_sp.py's
LLAMA_CASES = (
    ("loss", dict(num_layers=2, num_kv_heads=4, max_position_embeddings=64),
     (2, 32), 0),
    ("grads", dict(num_layers=1, num_kv_heads=4, max_position_embeddings=64),
     (1, 16), 1),
    # and grouped-query attention (the KV heads repeated before the ring)
    ("gqa", dict(num_layers=1, num_kv_heads=2, max_position_embeddings=64),
     (1, 16), 2),
)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            out.update(_flat(val, f"{prefix}{key}/"))
        return out
    return {prefix[:-1]: tree}


def _unflat(flat):
    tree = {}
    for name, val in flat.items():
        *path, leaf = name.split("/")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = val
    return tree


def _chunk(t, rank):
    Sl = t.shape[1] // P
    return t[:, rank * Sl:(rank + 1) * Sl]


def _rank_main(rank, store_path, data_path, out_path):
    """One rank of the ring: every result of this module, into
    ``out_path % rank``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, P),
                            rank=rank, world_size=P)
    try:
        group = dist.new_group(list(range(P)))
        data = dict(np.load(data_path))
        out = {}
        q, k, v, g = (_chunk(torch.from_numpy(data[f"ring/{n}"]), rank)
                      for n in "qkvg")
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = tra.ring_attention(*leaves, group=group)
        o.backward(g)
        out["ring/out"] = o.detach().numpy()
        for name, t in zip(("dq", "dk", "dv"), leaves):
            out[f"ring/{name}"] = t.grad.numpy()
        for name, over, _, _ in LLAMA_CASES:
            cfg = tl.llama_tiny(**over)
            params = tl.params_from_numpy(_unflat({
                key[len(name) + 3:]: val for key, val in data.items()
                if key.startswith(f"{name}/p/")}), device="cpu")
            leaves = _flat(params)
            for t in leaves.values():
                t.requires_grad_(True)
            ids = _chunk(torch.from_numpy(data[f"{name}/ids"]), rank)
            loss = tl.loss_fn(params, ids, ids, cfg, sp_group=group)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            out[f"{name}/loss"] = loss.detach().numpy()
            for key, gr in zip(leaves, grads):
                dist.all_reduce(gr, group=group)      # gloo: no AVG
                out[f"{name}/g/{key}"] = (gr / P).numpy()
        np.savez(out_path % rank, **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def inputs():
    import jax

    from paddle_tpu.models import llama as jl
    rng = np.random.default_rng(0)
    data = {f"ring/{n}": rng.standard_normal(RING_SHAPE).astype(np.float32)
            for n in "qkvg"}
    for name, over, shape, seed in LLAMA_CASES:
        tree = jax.tree_util.tree_map(
            np.asarray, jl.init_params(jl.llama_tiny(**over), seed=0))
        for key, val in _flat(tree).items():
            data[f"{name}/p/{key}"] = val
        data[f"{name}/ids"] = np.random.default_rng(seed).integers(
            0, 1024, shape).astype(np.int32)
    return data


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """The results of the 4 gloo ranks, one dict per rank."""
    d = tmp_path_factory.mktemp("ring")
    np.savez(d / "inputs.npz", **inputs)
    mp.start_processes(_rank_main, args=(
        str(d / "store"), str(d / "inputs.npz"), str(d / "rank%d.npz")),
        nprocs=P, join=True, start_method="spawn")
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(P)]


def _close(got, want, rel):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("offset", [-128, -37, 0, 37, 128])
def test_lse_variant_matches_jax(offset):
    """The JAX function works on [BH, S, D]; the port on [B, S, nH, hD]
    (B 1, nH = BH here)."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu.incubate.nn.kernels import flash_attention as jfa
    rng = np.random.default_rng(offset + 200)
    q, k, v, go = (rng.standard_normal((4, 128, 64)).astype(np.float32)
                   for _ in range(4))
    g_lse = rng.standard_normal((4, 128)).astype(np.float32)
    (jo, jlse), vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention_with_lse(a, b, c, offset),
        *(jnp.asarray(x) for x in (q, k, v)))
    jgrads = vjp((jnp.asarray(go), jnp.asarray(g_lse)))

    def port(x):
        return torch.from_numpy(x.transpose(1, 0, 2)[None].copy())

    def back(t):
        return t.detach()[0].numpy().transpose(1, 0, 2)

    leaves = [port(x).requires_grad_(True) for x in (q, k, v)]
    before = dict(tfa.LAUNCHES)
    out, lse = tfa.flash_attention_with_lse(*leaves, offset)
    want_out, want_lse = tfa.flash_attention_with_lse_plain(*leaves, offset)
    torch.autograd.backward([out, lse],
                            [port(go), torch.from_numpy(g_lse)[None]])
    assert tfa.LAUNCHES == before      # CPU tensors: plain versions
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    assert lse.dtype == torch.float32 and lse.shape == (1, 4, 128)
    np.testing.assert_allclose(back(out), np.asarray(jo), rtol=0, atol=1e-5)
    if offset <= -128:                        # no row sees a key
        assert (lse <= -1e29).all() and (np.asarray(jlse) <= -1e29).all()
        np.testing.assert_allclose(
            back(out), np.broadcast_to(v.mean(1, keepdims=True), v.shape),
            rtol=0, atol=1e-6)
    else:
        np.testing.assert_allclose(lse.detach()[0].numpy(), np.asarray(jlse),
                                   rtol=0, atol=1e-5)
    for t, want in zip(leaves, jgrads):
        _close(back(t.grad), want, 1e-5)


def test_lse_variant_offset_is_a_host_int():
    q = torch.zeros(1, 8, 1, 32)
    for bad in (torch.tensor(3), 2.0, None, 2 ** 31):
        with pytest.raises(TypeError, match="offset"):
            tfa.flash_attention_with_lse(q, q, q, bad)


def _jax_ring(inputs):
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as PS

    from paddle_tpu.incubate.nn.kernels.ring_attention import ring_attention
    mesh = Mesh(np.array(jax.devices()[:P]), ("sep",))
    spec = PS(None, "sep")
    f = shard_map(lambda a, b, c: ring_attention(a, b, c, "sep"), mesh=mesh,
                  in_specs=(spec,) * 3, out_specs=spec, check_rep=False)
    out, vjp = jax.vjp(jax.jit(f), *(jnp.asarray(inputs[f"ring/{n}"])
                                     for n in "qkv"))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(inputs["ring/g"])))]


def test_ring_matches_jax_shard_map(inputs, ranks):
    want = _jax_ring(inputs)
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        got = np.concatenate([r[f"ring/{name}"] for r in ranks], axis=1)
        _close(got, want[i], 1e-5)


def test_ring_replayed_in_one_process_matches_the_ranks(inputs, ranks):
    """``ring_attention_loop`` for each rank with a hand-over that returns
    the next chunk: the schedule without a process group."""
    q, k, v, g = (torch.from_numpy(inputs[f"ring/{n}"]) for n in "qkvg")
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    kc, vc = (list(t.chunk(P, dim=1)) for t in leaves[1:])
    outs = []
    for r in range(P):
        held = iter(range(r - 1, r - P, -1))

        def pass_kv(_k, _v):
            src = next(held) % P
            return kc[src], vc[src]
        outs.append(tra.ring_attention_loop(leaves[0].chunk(P, dim=1)[r],
                                            kc[r], vc[r], r, P, pass_kv))
    out = torch.cat(outs, dim=1)
    out.backward(g)
    got = [out.detach(), *(t.grad for t in leaves)]
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        want = np.concatenate([r[f"ring/{name}"] for r in ranks], axis=1)
        _close(got[i].numpy(), want, 1e-6)


def _jax_sp(name, over, inputs):
    """JAX's sp loss and its pmean-combined gradients (the two functions
    of ``tests/test_watchdog_sp.py``) for one case."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh, PartitionSpec as PS

    from paddle_tpu.models import llama as jl
    cfg = jl.llama_tiny(**over)
    params = jax.tree_util.tree_map(jnp.asarray, _unflat({
        key[len(name) + 3:]: val for key, val in inputs.items()
        if key.startswith(f"{name}/p/")}))
    ids = jnp.asarray(inputs[f"{name}/ids"])
    mesh = Mesh(np.array(jax.devices()[:P]), ("sep",))
    rep = jax.tree_util.tree_map(lambda _: PS(), params)

    def local(p, i):
        loss, g = jax.value_and_grad(lambda pp: jl.loss_fn(
            pp, i, i, cfg, sp_axis="sep"))(p)
        return loss, jax.tree_util.tree_map(
            lambda x: jax.lax.pmean(x, "sep"), g)

    f = shard_map(local, mesh=mesh, in_specs=(rep, PS(None, "sep")),
                  out_specs=(PS(), rep), check_rep=False)
    loss, grads = jax.jit(f)(params, ids)
    return float(loss), {k: np.asarray(v) for k, v in _flat(grads).items()}


@pytest.mark.parametrize("case", LLAMA_CASES, ids=[c[0] for c in LLAMA_CASES])
def test_llama_sp_matches_jax(inputs, ranks, case):
    name, over, _, _ = case
    want_loss, want_grads = _jax_sp(name, over, inputs)
    for r in ranks:
        np.testing.assert_allclose(float(r[f"{name}/loss"]), want_loss,
                                   rtol=2e-4)
    for key, want in want_grads.items():
        for r in ranks:                    # the combined grads, every rank
            np.testing.assert_allclose(r[f"{name}/g/{key}"], want, rtol=5e-3,
                                       atol=5e-5, err_msg=key)


def test_llama_sp_group_of_one_is_the_dense_loss(inputs):
    """A one-rank group (the ring at P = 1: one block at offset 0, no
    exchange): the loss and grads of ``loss_fn`` without a group."""
    name, over, _, _ = LLAMA_CASES[1]
    cfg = tl.llama_tiny(**over)
    ids = torch.from_numpy(inputs[f"{name}/ids"])
    flat = {key[len(name) + 3:]: val for key, val in inputs.items()
            if key.startswith(f"{name}/p/")}
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        results = []
        for group in (dist.group.WORLD, None):
            params = tl.params_from_numpy(_unflat(flat), device="cpu")
            leaves = list(_flat(params).values())
            for t in leaves:
                t.requires_grad_(True)
            loss = tl.loss_fn(params, ids, ids, cfg, sp_group=group)
            results.append((loss, torch.autograd.grad(loss, leaves)))
    finally:
        dist.destroy_process_group()
    (l1, g1), (l0, g0) = results
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
