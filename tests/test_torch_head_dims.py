"""The five attention kernels' plain versions at head dims the kernels run
on their general instances (8 on 16, 24 on 32, 33 on 64, 100 on 128, 136
and 256 on 256) and on the wide path (320, 512, and 1024 for the
forward) against the reference's Pallas kernels, which take each
head's whole d as one block (interpret mode off-TPU, as their own tests
run them): the flash forward within 2e-5 (``test_torch_flash.py``), the
backward within rtol 2e-4 and atol 2e-5 (``test_torch_flash_bwd.py``),
the int8-K/V forward and the paged int8 decode within 2e-5, with the
rows that see no key and the length-0 row exact zeros on both sides. A
tiny LM at head dim 256 (2 heads of ``d_model`` 512) and one at 512 (1
head) loaded through ``interop`` give the reference's logits and loss
under flash attention, and the one at 512 the reference engine's greedy
tokens through int8 pages. The fused int8 matmul's plain version gives
the reference kernel's bits at tiles outside the four the CUDA kernel
compiles a warp grid for.
The card runs the kernels themselves at these head dims
(``chip_smoke.py`` phase 3 and 22); ``test_torch_emu_head_dims.py`` and
``test_torch_emu_wide.py`` hold their sources against these plain
versions on the CPU."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
pytest.importorskip("flax")   # the reference package needs both
import jax.numpy as jnp  # noqa: E402

from tpu_dist.models import transformer as jtr  # noqa: E402
from tpu_dist.ops import flash_attention as jfa  # noqa: E402
from tpu_dist.ops import paged_attention as jpa  # noqa: E402
from tpu_dist_torch import kernels  # noqa: E402
from tpu_dist_torch.ops import flash_attention as tfa  # noqa: E402
from tpu_dist_torch.ops import paged_attention as tpa  # noqa: E402

torch.set_num_threads(1)

FWD_TOL = dict(rtol=2e-5, atol=2e-5)
BWD_TOL = dict(rtol=2e-4, atol=2e-5)
HEAD_DIMS = [8, 24, 33, 100, 136, 256, 320, 512]
FWD_HEAD_DIMS = HEAD_DIMS + [1024]


def _rand(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_the_head_dims_run_on_the_general_instances():
    """Each head dim here up to 256 runs on the next instance up (the true
    d at run time; 256 on its own), each above on the wide path."""
    assert {d: kernels.head_dim_instance(d) for d in FWD_HEAD_DIMS} == {
        8: 16, 24: 32, 33: 64, 100: 128, 136: 256, 256: 256, 320: "wide",
        512: "wide", 1024: "wide"}


# (b, lq, lk, h, causal, q_offset, kv_offset): rows 0..23 see no key in
# the first case
FWD_CASES = [(1, 48, 80, 2, True, 0, 24), (1, 40, 72, 1, False, 0, 0)]


@pytest.mark.parametrize("case", FWD_CASES, ids=str)
@pytest.mark.parametrize("d", FWD_HEAD_DIMS, ids=str)
def test_plain_flash_matches_pallas_forward(d, case):
    b, lq, lk, h, causal, qo, ko = case
    q, k, v = _rand(d + lq, (b, lq, h, d), (b, lk, h, d), (b, lk, h, d))
    jout, jlse = jfa._fa_forward(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal, qo, ko, 16, 16,
                                 True)
    tout, tlse = tfa.flash_forward(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=causal,
                                   q_offset=qo, kv_offset=ko)
    jout = np.asarray(jout)
    np.testing.assert_allclose(jout, tout.numpy(), **FWD_TOL)
    np.testing.assert_allclose(np.asarray(jlse)[..., 0], tlse.numpy(),
                               **FWD_TOL)
    if ko > qo:
        dead = qo + np.arange(lq) < ko
        assert np.all(jout[:, dead] == 0) and bool(
            (tout[:, torch.from_numpy(dead)] == 0).all())


@pytest.mark.parametrize("d", HEAD_DIMS, ids=str)
def test_plain_backward_matches_pallas_backward(d):
    """dq, dk, dv of a weighted sum through both packages' flash attention
    (the reference's Pallas backward pair, the port's
    ``flash_backward_plain``), with rows that see no key and keys that no
    row sees: exact zeros on both sides."""
    b, lq, lk, h, qo, ko = 1, 32, 48, 2, 0, 16
    q, k, v, w = _rand(d, (b, lq, h, d), (b, lk, h, d), (b, lk, h, d),
                       (b, lq, h, d))

    def loss(q_, k_, v_):
        return jnp.sum(jfa.flash_attention_fn(block_q=8, block_k=8)(
            q_, k_, v_, causal=True, q_offset=qo, kv_offset=ko) * w)

    ref = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = tfa.flash_attention_fn()(*ts, causal=True, q_offset=qo,
                                   kv_offset=ko)
    (out * torch.from_numpy(w)).sum().backward()
    got = [t.grad.numpy() for t in ts]
    for name, a, r in zip("qkv", got, ref):
        np.testing.assert_allclose(a, r, err_msg=f"d{name}", **BWD_TOL)
    dead_rows = qo + np.arange(lq) < ko
    dead_keys = ko + np.arange(lk) > qo + lq - 1
    for grads in (got, ref):
        assert np.all(grads[0][:, dead_rows] == 0)
        assert np.all(grads[1][:, dead_keys] == 0)
        assert np.all(grads[2][:, dead_keys] == 0)


@pytest.mark.parametrize("d", HEAD_DIMS, ids=str)
def test_int8kv_plain_matches_pallas_forward(d):
    b, lq, lk, h, qo, ko = 1, 48, 48, 2, 0, 16
    q, k, v = _rand(d + 1, (b, lq, h, d), (b, lk, h, d), (b, lk, h, d))
    jkv = jfa.quantize_kv(jnp.asarray(k), jnp.asarray(v))
    jout = np.asarray(jfa.int8kv_flash_attention_fn(block_q=16, block_k=16)(
        jnp.asarray(q), jkv, causal=True, q_offset=qo, kv_offset=ko))
    tkv = tfa.quantize_kv(torch.from_numpy(k), torch.from_numpy(v))
    tout = tfa.int8kv_flash_attention_fn()(
        torch.from_numpy(q), tkv, causal=True, q_offset=qo, kv_offset=ko)
    np.testing.assert_allclose(jout, tout.numpy(), **FWD_TOL)
    dead = qo + np.arange(lq) < ko
    assert np.all(jout[:, dead] == 0) and bool(
        (tout[:, torch.from_numpy(dead)] == 0).all())


@pytest.mark.parametrize("d", HEAD_DIMS, ids=str)
def test_plain_paged_decode_matches_pallas_kernel(d):
    rng = np.random.default_rng(d + 2)
    b, lk, h = 3, 32, 2
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    kq, vq = (rng.integers(-127, 128, (b, lk, h, d)).astype(np.int8)
              for _ in range(2))
    ks, vs = ((rng.random((b, lk, h)) * 0.05).astype(np.float32)
              for _ in range(2))
    lens = np.array([32, 0, 9], np.int32)
    args = (q, kq, ks, vq, vs, lens)
    jo = np.asarray(jpa.int8kv_paged_flash_attention_fn(block_k=8)(
        *map(jnp.asarray, args)))
    to = tpa.int8kv_paged_flash_attention_fn()(
        *(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_allclose(jo, to, **FWD_TOL)
    assert np.all(jo[1] == 0) and np.all(to[1] == 0)


def _lm_pair(geom, seed):
    """The reference's tiny LM under its flash attention, its params, and
    the port's loaded from them through ``interop``."""
    from tpu_dist_torch.interop import load_flax_params
    from tpu_dist_torch.models import transformer as ttr

    jlm = jtr.tiny_lm(attn_fn=jfa.flash_attention_fn(block_q=16, block_k=16),
                      **geom)
    params = jlm.init({"params": jax.random.PRNGKey(seed)},
                      jnp.zeros((1, geom["max_len"]), jnp.int32),
                      train=False)["params"]
    tlm = ttr.tiny_lm(attn_fn=tfa.flash_attention_fn(), device="cpu",
                      seed=None, **geom)
    load_flax_params(tlm, jax.tree_util.tree_map(np.asarray, params))
    return jlm, params, tlm


def _logits_and_loss_match(jlm, params, tlm, v, L):
    """fp32 logits within 1e-4, the mean token loss within 1e-5 (1 +
    |loss|) of the reference's."""
    from tpu_dist.engine.lm_steps import \
        lm_loss_and_metrics as j_loss  # noqa: E402
    from tpu_dist_torch.engine.lm_steps import lm_loss_and_metrics as t_loss

    rows = np.random.default_rng(4).integers(0, v, (2, L + 1)).astype(
        np.int32)
    inp, tgt = rows[:, :-1], rows[:, 1:]
    mask = np.ones(tgt.shape, np.float32)
    jl = jlm.apply({"params": params}, jnp.asarray(inp), train=False)
    with torch.inference_mode():
        tl = tlm(torch.from_numpy(inp))
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=1e-4,
                               atol=1e-4)
    jsum, jm = j_loss(jl, jnp.asarray(tgt), jnp.asarray(mask))
    tsum, tm = t_loss(tl, torch.from_numpy(tgt).long(),
                      torch.from_numpy(mask))
    want = float(jsum) / float(jm["count"])
    got = float(tsum) / float(tm["count"])
    assert abs(got - want) <= 1e-5 * (1 + abs(want)), (got, want)


def test_lm_at_head_dim_256_matches_reference():
    """A tiny LM with 2 heads of 256, weights through ``interop``: fp32
    logits within 1e-4 of the reference's under both packages' flash
    attention (the Pallas kernel in interpret mode), and the mean token
    loss within 1e-5 (1 + |loss|)."""
    v, L = 64, 16
    geom = dict(vocab_size=v, num_layers=1, d_model=512, num_heads=2,
                max_len=L)
    _logits_and_loss_match(*_lm_pair(geom, 3), v, L)


def test_lm_at_head_dim_512_matches_reference_and_serves_its_tokens():
    """A tiny fp32 LM with 1 head of 512 and 2 layers, weights through
    ``interop``: logits and loss as at 256, and both packages'
    ``ServeEngine`` over int8 pages read by the paged decode (flash
    prefill) give every request the same greedy tokens."""
    from tpu_dist.engine import serve as jserve
    from tpu_dist_torch.engine.serve import (DecodeRequest, ServeConfig,
                                             ServeEngine)

    v, L = 64, 32
    geom = dict(vocab_size=v, num_layers=2, d_model=512, num_heads=1,
                max_len=L)
    jlm, params, tlm = _lm_pair(geom, 5)
    _logits_and_loss_match(jlm, params, tlm, v, 16)
    prompts = [np.array([1, 9, 17], np.int32),
               (np.arange(11) * 7 % v).astype(np.int32)]
    steps = [10, 8]
    cfg = dict(max_slots=2, page_size=8, num_pages=16, kv_quant="int8",
               attn_read="flash")
    jcomps = jserve.ServeEngine(jlm, params, jserve.ServeConfig(**cfg)).run(
        [jserve.DecodeRequest(i, p, n)
         for i, (p, n) in enumerate(zip(prompts, steps))])
    tcomps = ServeEngine(tlm, ServeConfig(**cfg), device="cpu").run(
        [DecodeRequest(i, p, n) for i, (p, n) in enumerate(zip(prompts,
                                                               steps))])
    ref = {c.rid: c.tokens for c in jcomps}
    assert sorted(ref) == sorted(c.rid for c in tcomps) == [0, 1]
    for c in tcomps:
        np.testing.assert_array_equal(ref[c.rid], c.tokens)


@pytest.mark.parametrize("tile", [(8, 128, 0), (24, 384, 128)], ids=str)
def test_plain_fused_quant_matches_pallas_at_other_tiles(tile):
    """The reference's Pallas kernel (interpret mode) at a tile its
    ``set_quant_blocks`` takes and the CUDA kernel runs on its general
    instance gives its default tile's bits, and ``fused_quant_matmul_plain``
    (which the CUDA kernel matches bit for bit at every tile) is within
    1e-6 of it (``test_torch_pallas_quant.py``'s tolerance: the two
    dequantize in a different order), on a ragged shape."""
    from tpu_dist.ops import pallas_quant as jpq
    from tpu_dist_torch.ops import pallas_quant as tpq

    x, w = _rand(sum(tile), (40, 200), (200, 136))
    default = np.asarray(jpq.fused_quant_matmul(
        jnp.asarray(x), jnp.asarray(w), interpret=True))
    try:
        jpq.set_quant_blocks(*tile)
        want = np.asarray(jpq.fused_quant_matmul(
            jnp.asarray(x), jnp.asarray(w), interpret=True))
    finally:
        jpq.set_quant_blocks()
    np.testing.assert_array_equal(want, default)
    got = tpq.fused_quant_matmul_plain(torch.from_numpy(x),
                                       torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
