"""The port's attention kernels against the JAX kernels and references.

On the CPU the port's ``ops`` run each kernel's plain PyTorch version; they
are held to the Pallas kernels (interpret mode) and ``repro.kernels.ref`` on
a subset of the ``tests/test_kernels.py`` grid, with its tolerances: 2e-5
for fp32, 2e-2 for bf16.  The decode version also takes softcap, window and
slot positions, which the JAX decode kernel lacks; those are held to
``repro.models.layers.attend``, the reference model's decode attention.
``tests/test_torch_cuda.py`` holds the CUDA kernels to these plain versions
on a card.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention as jax_decode  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from repro.models.layers import attend as jax_attend  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def arrays(seed, dtype, *shapes):
    """numpy arrays from a seed, already rounded to ``dtype`` so both
    frameworks see the same values; returned as (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    js, ts = [], []
    for shape in shapes:
        x = jnp.asarray(rng.standard_normal(shape, dtype=np.float32)).astype(dtype)
        js.append(x)
        ts.append(torch.from_numpy(np.array(x, np.float32)).to(TORCH_DT[dtype]))
    return js, ts


def assert_close(port, want, dtype):
    np.testing.assert_allclose(port.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype] * 10)


@pytest.mark.parametrize("B,H,K,S,d", [(1, 4, 4, 128, 64), (2, 4, 1, 128, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opts", [
    dict(causal=True), dict(causal=True, window=64),
    dict(causal=True, softcap=30.0), dict(causal=False),
])
def test_flash_plain_matches_pallas_and_ref(B, H, K, S, d, dtype, opts):
    (q, k, v), (tq, tk, tv) = arrays(0, dtype, (B, H, S, d), (B, K, S, d),
                                     (B, K, S, d))
    got = ops.flash_attention(tq, tk, tv, **opts)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (B, H, S, d)
    assert_close(got, jax_flash(q, k, v, interpret=True, **opts), dtype)
    assert_close(got, jref.mha_reference(q, k, v, **opts), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_lengths_window_softcap_match_ref(dtype):
    """Ragged lengths, a window and softcap together (the gemma2 prefill
    case), on an S not divisible by any tile; valid query rows compared."""
    B, H, K, S, d = 3, 4, 2, 100, 64
    (q, k, v), (tq, tk, tv) = arrays(1, dtype, (B, H, S, d), (B, K, S, d),
                                     (B, K, S, d))
    lengths = np.array([100, 57, 9], np.int32)
    opts = dict(causal=True, window=16, softcap=50.0)
    got = ops.flash_attention(tq, tk, tv, lengths=torch.from_numpy(lengths), **opts)
    want = jref.mha_reference(q, k, v, lengths=jnp.asarray(lengths), **opts)
    for b, n in enumerate(lengths):
        assert_close(got[b, :, :n], want[b, :, :n], dtype)


# the last two: G = 3 (granite-moe-3b-a800m's 24 heads on 8) and G = 6 (dbrx-132b's)
@pytest.mark.parametrize("B,H,K,T,d", [(2, 8, 2, 1024, 64), (1, 4, 4, 512, 128),
                                       (2, 24, 8, 256, 64), (1, 12, 2, 256, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas_and_ref(B, H, K, T, d, dtype):
    (q, k, v), (tq, tk, tv) = arrays(2, dtype, (B, H, d), (B, K, T, d),
                                     (B, K, T, d))
    lengths = np.random.default_rng(0).integers(1, T + 1, size=B).astype(np.int32)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    jl = jnp.asarray(lengths)
    assert_close(got, jax_decode(q, k, v, jl, interpret=True), dtype)
    assert_close(got, jref.decode_attention_reference(q, k, v, jl), dtype)


def ring_slots(T, q_pos, seed):
    """slot_pos of a cache in ring layout: slot t holds the latest position
    ≡ t (mod T) up to q_pos, with a few empty (padded) slots."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)[None, :]
    qp = q_pos[:, None]
    pos = qp - ((qp - t) % T)
    pos = np.where(pos >= 0, pos, -1)
    pos[rng.random(pos.shape) < 0.1] = -1
    return pos.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (0, 50.0), (24, 50.0),
                                            (200, 30.0)])
def test_decode_plain_matches_attend(dtype, window, softcap):
    """Softcap, window and slot positions as the model decodes: held to the
    reference's ``attend`` on the cache layout (B, T, K, d), with q_pos past
    T for one sequence so its ring has wrapped."""
    B, H, K, T, d = 3, 8, 4, 96, 64
    (q, k, v), (tq, tk, tv) = arrays(3, dtype, (B, 1, H, d), (B, T, K, d),
                                     (B, T, K, d))
    q_pos = np.array([40, 95, 130], np.int32)
    slot_pos = ring_slots(T, q_pos, seed=4)
    w = window if window else 1 << 30       # the reference's GLOBAL_WINDOW
    want = jax_attend(q, k, v, jnp.asarray(q_pos)[:, None], jnp.asarray(slot_pos),
                      causal=True, window=w, softcap=softcap,
                      k_valid=jnp.asarray(slot_pos >= 0))
    got = ops.decode_attention(
        tq[:, 0], tk.transpose(1, 2), tv.transpose(1, 2),
        torch.full((B,), T, dtype=torch.int32), softcap=softcap, window=window,
        q_pos=torch.from_numpy(q_pos), slot_pos=torch.from_numpy(slot_pos))
    assert_close(got, want[:, 0], dtype)


def test_decode_mask_without_slots_is_the_lengths_mask():
    """Without slot_pos (and window 0) the decode mask reduces to the JAX
    kernel's ``t < lengths`` mask; with a window it keeps the last keys."""
    from repro_torch.kernels.ref import decode_mask
    lengths = torch.tensor([5, 1, 8], dtype=torch.int32)
    t = torch.arange(8)[None, :]
    assert torch.equal(decode_mask(lengths, 8), t < lengths[:, None])
    m = decode_mask(lengths, 8, window=3)
    assert torch.equal(m, (t < lengths[:, None]) & (t > lengths[:, None] - 4))


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors ops never reaches a kernel: the launch counts stay."""
    before = (fa.launches, da.launches)
    _, (tq, tk, tv) = arrays(5, "float32", (1, 2, 8, 64), (1, 1, 8, 64),
                             (1, 1, 8, 64))
    ops.flash_attention(tq, tk, tv)
    ops.decode_attention(tq[:, :, 0], tk, tv, torch.tensor([8], dtype=torch.int32))
    assert (fa.launches, da.launches) == before


# ----------------------------------------------- K2's split-KV planner
@pytest.mark.parametrize("B,K,T,d,itemsize", [
    (8, 4, 4736, 256, 2), (8, 1, 2048, 256, 2), (2, 2, 1000, 128, 2),
    (3, 2, 300, 64, 4), (1, 1, 100000, 128, 2), (8, 1, 1, 256, 2), (8, 1, 0, 256, 2),
    (4, 4, 528, 256, 2), (300, 1, 4096, 256, 2), (1, 1, 65, 256, 4)])
def test_split_plan_covers_every_slot_once(B, K, T, d, itemsize):
    """Split s holds slots [s·chunk, min((s + 1)·chunk, T)): every slot in
    exactly one split, whole tiles, and no empty split unless T = 0."""
    n, chunk = da.plan_splits(B, K, T, d, itemsize)
    assert n >= 1 and chunk > 0 and chunk % da.SPLIT_SLOTS == 0
    ranges = [range(s * chunk, min((s + 1) * chunk, T)) for s in range(n)]
    covered = [t for r in ranges for t in r]
    assert covered == list(range(T))
    assert all(len(r) for r in ranges) or (T == 0 and n == 1)


@pytest.mark.parametrize("arch,B,K,T", [("gemma2-2b", 8, 4, 4736), ("gemma2-2b", 8, 4, 4716),
                                        ("recurrentgemma-9b", 8, 1, 2048)])
def test_split_plan_fills_the_card_at_decode_shapes(arch, B, K, T):
    """At the models' decode shapes (batch 8, d = 256, bf16) the grid holds
    at least about two blocks per SM of the H100's 132, and not much more
    than the planner's aim."""
    n, _ = da.plan_splits(B, K, T, 256, 2)
    blocks = B * K * n
    assert 0.9 * 2 * 132 <= blocks <= 1.2 * da.BLOCKS_PER_SM * 132, (arch, n, blocks)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_plan_keeps_one_split_at_the_calibration_shapes(dtype):
    """The calibration's decode points (T ≤ 256, d = 64) run one split: a
    block reads a whole (b, kv head) in microseconds, and no combining
    kernel is launched."""
    from repro_torch.calibrate.kernel_bench import (DEFAULT_BATCHES, DEFAULT_SEQS,
                                                    kernel_registry)
    case = kernel_registry()["decode_attention"]
    for batch in DEFAULT_BATCHES:
        for seq in DEFAULT_SEQS:
            (q, k, _, _), _ = case.make(batch, seq, dtype, 0, "cpu")
            B, K, T, d = k.shape
            assert da.plan_splits(B, K, T, d, q.element_size()) == (1, seq)


# ----------------------------------------------- K1's forward launch plan
def _source_constants():
    """The launch constants of csrc/flash_attention.cu, read from the source."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "flash_attention.cu").read_text()
    const = {name: int(val) for name, val in
             re.findall(r"constexpr int (\w+) = (\d+);", src)}
    const["BQ_WG"] = int(re.search(r"BQ_WG = (\d+) \* WG_ROWS", src)[1]) * const["WG_ROWS"]
    const["WG_THREADS"] = int(re.search(r"WG_THREADS = (\d+) \* 128", src)[1]) * 128
    big, small = re.search(r"kv_tile\(\) \{ return D == 256 \? (\d+) : (\d+); \}", src).groups()
    const["kv_tile"] = {d: int(big) if d == 256 else int(small) for d in fa.HEAD_DIMS}
    return const


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_flash_plan_follows_the_source_and_fits_shared_memory(d, dtype):
    """The wrapper's plan is the source's launch (rows a block, threads,
    stages, kv tile; ``KV_TILE``, which chip_smoke.py's planted faults
    read, is the plan's), and a block's shared memory fits the H100's
    227 KB."""
    c = _source_constants()
    p = fa.plan(2, 8, 300, d, dtype)
    assert p.kv_tile == fa.KV_TILE[dtype, d]
    if dtype == torch.float32:
        assert (p.rows, p.kv_tile, p.threads, p.longest_first) == (
            c["BQ"], c["BK"], c["NTHREADS"], False)
    else:
        assert (p.rows, p.kv_tile, p.stages, p.threads, p.longest_first) == (
            c["BQ_WG"], c["kv_tile"][d], c["WG_STAGES"], c["WG_THREADS"], True)
    assert p.smem <= fa.SMEM_LIMIT
    assert p.grid == (-(-300 // p.rows), 8, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ["whisper-tiny", "recurrentgemma-9b", "granite-moe-3b-a800m",
                                  "dbrx-132b", "gemma2-2b", "granite-3-2b", "granite-8b",
                                  "yi-9b", "rwkv6-7b", "llava-next-34b"])
def test_flash_plan_covers_every_row_once(arch, dtype):
    """At each catalog arch's head shape, for the 32k prefill, a ragged 4700
    and the 432-row cross-attention of whisper-tiny, every (sequence, head,
    query row) falls in exactly one block, and no block lies past the
    rows."""
    from repro_torch.configs import SHAPES, get_config
    cfg = get_config(arch)
    assert cfg.head_dim in fa.HEAD_DIMS
    for Sq in (SHAPES["prefill_32k"].seq_len, 4700, 432, 1):
        p = fa.plan(3, cfg.num_heads, Sq, cfg.head_dim, dtype)
        assert p.grid[1:] == (cfg.num_heads, 3)
        seen = np.zeros(Sq, dtype=np.int64)
        for x in range(p.grid[0]):
            rows = p.block_rows(x)
            assert rows.start < Sq
            seen[rows.start:min(rows.stop, Sq)] += 1
        assert (seen == 1).all(), (arch, Sq)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Skv,causal,window,length", [
    (300, 300, True, 0, 300), (300, 300, True, 0, 131), (4700, 4700, True, 4096, 4700),
    (700, 700, True, 48, 650), (432, 1500, False, 0, 1500), (77, 333, False, 0, 200),
    (1, 1, True, 0, 1), (129, 129, True, 64, 5)])
def test_flash_plan_reads_every_live_key(Sq, Skv, causal, window, length, dtype):
    """Each block reads whole kv tiles holding every key a row of it may
    see (below ``length``, causal, in the window), and skips the tiles
    where none of its rows sees a key."""
    d = 128
    p = fa.plan(1, 1, Sq, d, dtype)
    key = np.arange(Skv)
    for x in range(p.grid[0]):
        rows = np.arange(p.block_rows(x).start, min(p.block_rows(x).stop, Sq))
        live = key[None, :] < length
        if causal:
            live = live & (key[None, :] <= rows[:, None])
        if window:
            live = live & (key[None, :] > rows[:, None] - window)
        read = p.kv_range(x, Sq, length, causal, window)
        assert read.start % p.kv_tile == 0 and len(read) % p.kv_tile == 0
        seen = live.any(axis=0)
        assert all(read.start <= j < read.stop for j in np.flatnonzero(seen))
        for t0 in range(read.start, read.stop, p.kv_tile):
            assert seen[t0:t0 + p.kv_tile].any(), (x, t0)


# --------------------------------------------- K1′'s bf16 launch plan
def _bwd_source_constants():
    """The bf16 launch constants of csrc/flash_attention_bwd.cu, from the source."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "flash_attention_bwd.cu").read_text()
    const = {name: int(val) for name, val in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    const["WG_THREADS"] = int(re.search(r"WG_THREADS = (\d+) \* 128", src)[1]) * 128
    dq = re.search(r"struct DqTiles \{(.*?)\};", src, re.S)[1]
    dkv = re.search(r"struct DkvTiles \{(.*?)\};", src, re.S)[1]
    const["dq_rows"] = int(re.search(r"BQ = (\d+) \* WG_ROWS", dq)[1]) * const["WG_ROWS"]
    for name, body, field, at in (("dq_kv_tile", dq, "BKV", 256), ("dkv_q_tile", dkv, "BQ", 256),
                                  ("dkv_keys", dkv, "BKV", 64)):
        one, other = re.search(field + f" = D == {at}" + r" \? (\d+) : (\d+);", body).groups()
        const[name] = {d: int(one) if d == at else int(other) for d in fa.HEAD_DIMS}
    return const


# phase 18's bf16 K1′ cases (B, H, K, Sq, Skv, d), and a cross shape with
# ragged tiles
BWD_SHAPES = {"granite-3-2b": (4, 32, 8, 2048, 2048, 64),
              "gemma2-2b": (2, 8, 4, 4700, 4700, 256),
              "recurrentgemma-9b": (2, 16, 1, 4096, 4096, 256),
              "whisper-tiny encoder": (4, 6, 6, 1500, 1500, 64),
              "whisper-tiny cross-attention": (4, 6, 6, 432, 1500, 64),
              "llava-next-34b": (4, 56, 8, 3392, 3392, 128),
              "cross 77 x 333": (2, 4, 2, 77, 333, 128)}


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_flash_plan_bwd_follows_the_source_and_fits_shared_memory(d):
    """The backward's plan is the source's two launches (rows and keys a
    block, tiles, stages, threads), the lse and D pitch a whole number of
    tiles, and each block's shared memory fits the H100's 227 KB."""
    c = _bwd_source_constants()
    p = fa.plan_bwd(2, 8, 4, 300, 500, d)
    assert (p.dq_rows, p.dq_kv_tile, p.dkv_keys, p.dkv_q_tile, p.stages, p.threads) == (
        c["dq_rows"], c["dq_kv_tile"][d], c["dkv_keys"][d], c["dkv_q_tile"][d], c["STAGES"],
        c["WG_THREADS"])
    assert fa.STATS_ROWS == c["kStatsRows"]
    assert fa.STATS_ROWS % p.dq_rows == 0 and fa.STATS_ROWS % p.dkv_q_tile == 0
    assert max(p.dq_smem, p.dkv_smem) <= fa.SMEM_LIMIT
    assert p.dq_grid == (8, 2, -(-300 // p.dq_rows))
    assert p.dkv_grid == (4, 2, -(-500 // p.dkv_keys))


@pytest.mark.parametrize("case", list(BWD_SHAPES))
def test_flash_plan_bwd_covers_every_row_and_key_once(case):
    """At phase 18's shapes and a cross shape, every (sequence, head, query
    row) falls in exactly one dQ block and every (sequence, kv head, key)
    in exactly one dK/dV block, no block past the rows or keys, and each
    head's query rows and keys reach the lse and D pitch."""
    B, H, K, Sq, Skv, d = BWD_SHAPES[case]
    p = fa.plan_bwd(B, H, K, Sq, Skv, d)
    assert p.dq_grid[:2] == (H, B) and p.dkv_grid[:2] == (K, B)
    for n, blocks, span in ((Sq, p.dq_grid[2], p.dq_block_rows),
                            (Skv, p.dkv_grid[2], p.dkv_block_keys)):
        seen = np.zeros(n, dtype=np.int64)
        for z in range(blocks):
            rows = span(z)
            assert rows.start < n
            seen[rows.start:min(rows.stop, n)] += 1
        assert (seen == 1).all(), case
    assert max(p.dq_block_rows(0).stop, p.dq_grid[2] * p.dq_rows) == fa.stats_pitch(Sq)


def _held_ratio(got, want):
    """chip_smoke.py's one-bf16-ulp limit: max |got − want| / (1e-5 + 2^-7·|want|)."""
    return float(((got - want).abs() / (1e-5 + 2.0 ** -7 * want.abs())).max())


def test_split_p_holds_one_bf16_ulp():
    """Why the tensor-core kernels split P into bf16 parts for P·V: with
    gemma2-2b's decode shape (2 query heads per kv head, d = 256, softcap
    50, 4736 slots), P rounded once to bf16 moves the bf16 output past the
    one-ulp limit against the product with P unrounded; in two parts, hi +
    mid (16 significant bits, as K2 takes it), or three, hi + mid + lo (24,
    as K1 takes it: see its source), it stays within.  CPU emulation of the
    roundings, fp32 sums."""
    import math
    rng = np.random.default_rng(0)
    G, T, d = 8, 4736, 256
    q = torch.from_numpy(rng.standard_normal((G, d), dtype=np.float32)).bfloat16().float()
    k, v = (torch.from_numpy(rng.standard_normal((T, d), dtype=np.float32)).bfloat16().float()
            for _ in range(2))
    logits = 50.0 * torch.tanh(q @ k.T / math.sqrt(d) / 50.0)
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    l = e.sum(-1, keepdim=True)
    want = ((e / l) @ v).bfloat16().float()
    hi = e.bfloat16().float()
    mid = (e - hi).bfloat16().float()
    lo = (e - hi - mid).bfloat16().float()
    assert _held_ratio(((hi / l) @ v).bfloat16().float(), want) > 1.0
    assert _held_ratio((((hi + mid) / l) @ v).bfloat16().float(), want) <= 1.0
    assert _held_ratio((((hi + mid + lo) / l) @ v).bfloat16().float(), want) <= 1.0


@pytest.mark.parametrize("window", [0, 9])
def test_plain_attention_computes_in_acc(window):
    """The plain attention versions compute in fp32 unless asked for float64
    (``acc``), the check of the kernels; float64 gives the direct float64
    computation (causal, softcap and lengths, with and without a window),
    and the default stays the fp32 computation of the CPU path."""
    import math
    from repro_torch.kernels.ref import (NEG_INF, decode_attention_reference, decode_mask,
                                         mha_reference)
    rng = np.random.default_rng(7)
    B, H, K, S, d = 2, 2, 1, 53, 8
    q = torch.from_numpy(rng.standard_normal((B, H, S, d)))
    k, v = (torch.from_numpy(rng.standard_normal((B, K, S, d))) for _ in range(2))
    lengths = torch.tensor([S, 40], dtype=torch.int32)
    kw = dict(causal=True, window=window, softcap=30.0, lengths=lengths)
    got = mha_reference(q, k, v, acc=torch.float64, **kw)
    assert got.dtype == torch.float64
    logits = torch.einsum("bkgsd,bktd->bkgst", q.reshape(B, K, 2, S, d), k) / math.sqrt(d)
    logits = 30.0 * torch.tanh(logits / 30.0)
    i, j = torch.arange(S)[:, None], torch.arange(S)[None, :]
    mask = (j <= i) & ((j > i - window) if window else True) & (j[None] < lengths[:, None, None])
    p = torch.softmax(torch.where(mask[:, None, None], logits, NEG_INF), dim=-1)
    want = torch.einsum("bkgst,bktd->bkgsd", p, v).reshape(B, H, S, d)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    fp32 = mha_reference(q, k, v, **kw)
    torch.testing.assert_close(fp32, mha_reference(q.float(), k.float(), v.float(), **kw)
                               .double(), rtol=0, atol=0)
    assert 0 < float((fp32 - want).abs().max()) < 1e-5
    # decode: the last query row of each sequence against the same cache
    qd = q[torch.arange(B), :, lengths.long() - 1]
    got = decode_attention_reference(qd, k, v, lengths, softcap=30.0, window=window,
                                     acc=torch.float64)
    lg = torch.einsum("bkgd,bktd->bkgt", qd.reshape(B, K, 2, d), k) / math.sqrt(d)
    lg = torch.where(decode_mask(lengths, S, window=window)[:, None, None],
                     30.0 * torch.tanh(lg / 30.0), NEG_INF)
    want = torch.einsum("bkgt,bktd->bkgd", torch.softmax(lg, dim=-1), v).reshape(B, H, d)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
