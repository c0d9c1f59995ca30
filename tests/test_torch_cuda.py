"""The CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``gpu`` and skips without a CUDA device; on the
H100 run them with ``python -m pytest -q -m gpu tests/test_torch_cuda.py``.
The plain versions are themselves held to the JAX kernels and references by
``tests/test_torch_kernels.py``, ``tests/test_torch_rglru.py`` and
``tests/test_torch_rwkv6.py``.  Tolerances are those of
``tests/test_kernels.py``: 2e-5 for fp32, 2e-2 for bf16 (fp32 products stay
IEEE: TF32 is switched off), bitwise for the RG-LRU scan (ring or
register variant, as its ``plan`` chooses), atol 2e-4 and rtol
1e-3 for the WKV6 state (and for its output in fp32; one bf16 ulp in bf16),
against the plain version in fp32 and, across the chunked kernel's segment
and chunk boundaries, in float64.  The int8 matmul is held bitwise to its
exact plain version, with w row-major (transposed into scratch) and
column-major (read in place); its plain version is held to the Pallas kernel
by ``tests/test_torch_int8.py``.  K1's backward kernel is held to the
plain version's gradient (``fa.plain_grad``, autograd through
``mha_reference``) in float64 within 2^-14·max|want| + one ulp of its type,
the form and limit of ``chip_smoke.py`` phase 18, including d = 256 with a
window on a tile edge and ragged lengths, and must give the same bits on two
calls; the backward kernels of
K3 and K4 likewise, to ``rg.plain_grad`` and ``wk.plain_grad`` (the explicit
formulas of ``ref``) in float64, within 2^-14·max|want| plus one ulp of each
output's type, with planted faults that must fail by 10x.  K2 and K5, which
have no backward kernel, must raise when a gradient is wanted.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import int8_matmul as i8  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def arrays(seed, dtype, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(TORCH_DT[dtype])
            for s in shapes]


def assert_close(port, want, dtype):
    np.testing.assert_allclose(port.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype] * 10)


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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opts", [dict(causal=True, window=48, softcap=50.0),
                                  dict(causal=False)])
def test_flash_kernel_matches_plain(cuda, d, dtype, opts):
    B, H, K, S = 3, 8, 2, 200
    tq, tk, tv = arrays(6, dtype, (B, H, S, d), (B, K, S, d), (B, K, S, d))
    tq, tk, tv = (t.to(cuda) for t in (tq, tk, tv))
    lengths = torch.tensor([200, 131, 5], dtype=torch.int32, device=cuda)
    n0 = fa.launches
    got = fa.flash_attention(tq, tk, tv, lengths=lengths, **opts)
    assert fa.launches == n0 + 1
    want = fa.plain(tq, tk, tv, lengths=lengths, **opts)
    for b, n in enumerate((200, 131, 5)):
        assert_close(got[b, :, :n], want[b, :, :n], dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("d", da.HEAD_DIMS)
@pytest.mark.parametrize("G", da.GROUP_SIZES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_matches_plain(cuda, d, G, dtype):
    B, K, T = 3, 2, 300
    tq, tk, tv = arrays(7, dtype, (B, G * K, d), (B, T, K, d), (B, T, K, d))
    tq, tk, tv = tq.to(cuda), tk.to(cuda).transpose(1, 2), tv.to(cuda).transpose(1, 2)
    q_pos = np.array([17, 299, 450], np.int32)
    slot_pos = torch.from_numpy(ring_slots(T, q_pos, seed=8)).to(cuda)
    kw = dict(softcap=50.0, window=64, q_pos=torch.from_numpy(q_pos).to(cuda),
              slot_pos=slot_pos)
    lengths = torch.full((B,), T, dtype=torch.int32, device=cuda)
    got = da.decode_attention(tq, tk, tv, lengths, **kw)
    assert_close(got, da.plain(tq, tk, tv, lengths, **kw), dtype)
    got = da.decode_attention(tq, tk, tv, lengths - 7)
    assert_close(got, da.plain(tq, tk, tv, lengths - 7), dtype)


def decode_case(seed, dtype, B, H, K, T, d, device):
    """q (B, H, d) and a cache in the model's (B, T, K, d) layout handed over
    as (B, K, T, d) views, from numpy normals."""
    tq, tk, tv = arrays(seed, dtype, (B, H, d), (B, T, K, d), (B, T, K, d))
    return tq.to(device), tk.to(device).transpose(1, 2), tv.to(device).transpose(1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["many_splits", "one_slot", "ragged", "empty_row",
                                  "empty_splits", "window_without_slots"])
def test_decode_kernel_split_edges(cuda, dtype, case):
    """Split-KV edges: gemma2-2b's decode shape (9 splits), T = 1, T not a
    multiple of the split or the tile, a row of lengths 0 (all zeros), a
    slot_pos in which whole splits hold no live slot, and a window without
    slot_pos (splits before the window return at once)."""
    B, H, K, T, d = {"many_splits": (8, 8, 4, 4736, 256), "one_slot": (3, 8, 4, 1, 256),
                     "ragged": (2, 4, 2, 1000, 128), "empty_row": (3, 4, 2, 777, 64),
                     "empty_splits": (2, 8, 4, 1500, 256),
                     "window_without_slots": (3, 8, 2, 3000, 128)}[case]
    tq, tk, tv = decode_case(11, dtype, B, H, K, T, d, cuda)
    rng = np.random.default_rng(12)
    lengths = torch.from_numpy(rng.integers(1, T + 1, B).astype(np.int32))
    lengths[0] = T
    kw = dict(softcap=50.0)
    if case == "empty_row":
        lengths[1] = 0
    if case == "empty_splits":
        n, chunk = da.plan_splits(B, K, T, d, tk.element_size())
        assert n >= 3
        q_pos = torch.full((B,), T - 1, dtype=torch.int32)
        slot_pos = torch.arange(T, dtype=torch.int32)[None].repeat(B, 1)
        slot_pos[:, :chunk] = -1                 # the first split, and
        slot_pos[1, chunk:3 * chunk] = -1        # two more of row 1
        kw.update(q_pos=q_pos.to(cuda), slot_pos=slot_pos.to(cuda))
    if case == "window_without_slots":
        kw.update(window=700)
    lengths = lengths.to(cuda)
    n0 = da.launches
    got = da.decode_attention(tq, tk, tv, lengths, **kw)
    torch.cuda.synchronize()
    assert da.launches == n0 + 1
    assert bool(torch.isfinite(got).all())
    want = da.plain(tq, tk, tv, lengths, **kw)
    if case == "empty_row":                  # no live slot: 0 (the plain version
        assert not bool(got[1].any())        # averages v there)
        got, want = got[[0, 2]], want[[0, 2]]
    assert_close(got, want, dtype)
    if case == "many_splits":
        assert da.plan_splits(B, K, T, d, tk.element_size())[0] > 1


@pytest.mark.gpu
@pytest.mark.parametrize("d", da.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_sixteen_heads_per_kv_head(cuda, d, dtype):
    """G = 16 (recurrentgemma-9b's 16 query heads on one kv head) over a
    2048-slot ring, split across blocks, at every head dimension; a planted
    fault (heads 8-15 given heads 0-7's queries) must fail the check."""
    B, K, T = 4, 1, 2048
    tq, tk, tv = decode_case(13, dtype, B, 16, K, T, d, cuda)
    q_pos = np.array([4000, 2047, 1000, 5], np.int32)
    kw = dict(window=T, q_pos=torch.from_numpy(q_pos).to(cuda),
              slot_pos=torch.from_numpy(ring_slots(T, q_pos, seed=14)).to(cuda))
    lengths = torch.from_numpy(np.minimum(q_pos + 1, T).astype(np.int32)).to(cuda)
    assert da.plan_splits(B, K, T, d, tk.element_size())[0] > 1
    got = da.decode_attention(tq, tk, tv, lengths, **kw)
    want = da.plain(tq, tk, tv, lengths, **kw)
    assert_close(got, want, dtype)
    q_dup = tq.clone()
    q_dup[:, 8:16] = tq[:, 0:8]
    with pytest.raises(AssertionError):
        assert_close(da.decode_attention(q_dup, tk, tv, lengths, **kw), want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 15, 64, 65, 200, 1000])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_ragged_lengths(cuda, S, d, dtype):
    """S on and off the 64-row query tile and the 64-key kv tile, ragged
    lengths (one 0), causal with softcap in the model's (B, S, heads, d)
    layout; rows past a length are padding and not compared."""
    B, H, K = 3, 4, 2
    tq, tk, tv = arrays(15, dtype, (B, S, H, d), (B, S, K, d), (B, S, K, d))
    tq, tk, tv = (t.to(cuda).transpose(1, 2) for t in (tq, tk, tv))
    rows = (S, max(1, S // 2 + 1), 0)
    lengths = torch.tensor(rows, dtype=torch.int32, device=cuda)
    kw = dict(causal=True, softcap=50.0, lengths=lengths)
    got = fa.flash_attention(tq, tk, tv, **kw)
    want = fa.plain(tq, tk, tv, **kw)
    assert bool(torch.isfinite(got).all())
    for b, n in enumerate(rows):
        assert_close(got[b, :, :n], want[b, :, :n], dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [64, 128, 65])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_window_edge_on_a_tile_boundary(cuda, window, dtype):
    """A window of 64 or 128 puts row q's first key q - window + 1 on a
    64-key tile boundary for every row q ≡ 63 (mod 64); 65 just past it.  A
    window one tile wide must fail the check."""
    B, H, K, S, d = 2, 8, 4, 333, 256
    tq, tk, tv = arrays(16, dtype, (B, H, S, d), (B, K, S, d), (B, K, S, d))
    tq, tk, tv = (t.to(cuda) for t in (tq, tk, tv))
    kw = dict(causal=True, window=window, softcap=30.0)
    want = fa.plain(tq, tk, tv, **kw)
    assert_close(fa.flash_attention(tq, tk, tv, **kw), want, dtype)
    with pytest.raises(AssertionError):
        assert_close(fa.flash_attention(tq, tk, tv, **{**kw, "window": window + 64}),
                     want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("Sq", [17, 432])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_cross_attention_over_more_keys_than_queries(cuda, Sq, d, dtype):
    """An encoder-decoder's cross-attention: Sq text rows against Skv = 1500
    encoder keys (whisper-tiny's frames), not causal, no lengths, one query
    head per kv head, in the model's (B, S, heads, d) layout.  A kernel that
    read the keys only up to Sq must fail the check."""
    B, H, Skv = 2, 6, 1500
    tq, tk, tv = arrays(17, dtype, (B, Sq, H, d), (B, Skv, H, d), (B, Skv, H, d))
    tq, tk, tv = (t.to(cuda).transpose(1, 2) for t in (tq, tk, tv))
    n0 = fa.launches
    got = fa.flash_attention(tq, tk, tv, causal=False)
    assert fa.launches == n0 + 1
    want = fa.plain(tq, tk, tv, causal=False)
    assert_close(got, want, dtype)
    cut = torch.full((B,), Sq, dtype=torch.int32, device=cuda)
    with pytest.raises(AssertionError):
        assert_close(fa.flash_attention(tq, tk, tv, causal=False, lengths=cut), want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 2, 7])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("case", ["causal", "cross", "window", "softcap", "ragged"])
def test_flash_bf16_kernel_holds_one_ulp_of_float64(cuda, case, d, G):
    """K1's bf16 kernel (wgmma) against the plain version in float64, within
    one bf16 ulp (1e-5 + 2^-7·|want|, chip_smoke.py's limit), with G query
    heads per kv head, Sq and Skv not multiples of any tile (the ragged
    edges TMA fills with zeros): causal; not causal with Sq < Skv; a window
    of 48; softcap 50; ragged lengths, rows past a length not compared.  Two
    calls give the same bits."""
    Sq, Skv, kw, lengths = {"causal": (203, 203, dict(causal=True), None),
                            "cross": (77, 333, dict(causal=False), None),
                            "window": (300, 300, dict(causal=True, window=48), None),
                            "softcap": (150, 150, dict(causal=True, softcap=50.0), None),
                            "ragged": (260, 260, dict(causal=True), (260, 131, 5))}[case]
    B, K = 3, 2
    tq, tk, tv = arrays(23, "bfloat16", (B, Sq, K * G, d), (B, Skv, K, d), (B, Skv, K, d))
    tq, tk, tv = (t.to(cuda).transpose(1, 2) for t in (tq, tk, tv))
    if lengths:
        kw = dict(kw, lengths=torch.tensor(lengths, dtype=torch.int32, device=cuda))
    got = fa.flash_attention(tq, tk, tv, **kw)
    assert torch.equal(got, fa.flash_attention(tq, tk, tv, **kw))
    want = fa.plain(tq, tk, tv, acc=torch.float64, **kw)
    for b, n in enumerate(lengths or (Sq,) * B):
        err = (got[b, :, :n].double() - want[b, :, :n]).abs()
        assert float((err / (1e-5 + 2.0 ** -7 * want[b, :, :n].abs())).max()) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 7])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_without_slot_positions(cuda, G, d, dtype):
    """One decode token against all T = 1500 slots with q_pos and slot_pos
    None (the cross-attention's decode): every slot t < T counts, as with
    slot t at position t and the query at T − 1; split across blocks."""
    B, K, T = 3, 2, 1500
    tq, tk, tv = decode_case(18, dtype, B, G * K, K, T, d, cuda)
    lengths = torch.full((B,), T, dtype=torch.int32, device=cuda)
    assert da.plan_splits(B, K, T, d, tk.element_size())[0] > 1
    got = da.decode_attention(tq, tk, tv, lengths)
    assert_close(got, da.plain(tq, tk, tv, lengths), dtype)
    slot_pos = torch.arange(T, dtype=torch.int32, device=cuda).repeat(B, 1)
    assert torch.equal(got, da.decode_attention(tq, tk, tv, lengths, q_pos=lengths - 1,
                                                slot_pos=slot_pos))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["whisper-tiny", "llava-next-34b"])
def test_encdec_and_vlm_on_the_card_match_their_cpu_runs(cuda, name):
    """Reduced whisper-tiny and llava-next-34b in fp32 on the same weights on
    the card (K1 and K2) and on the CPU (their plain versions): prefill
    logits within 1e-3, greedy tokens of the engine at the default cache
    length (the encoder-decoder's longest row decodes past the last slot)
    equal."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, reduced
    from repro_torch.serving.engine import make_generate_fn, make_prefill_fn
    cfg = reduced(get_config(name), head_dim=64)     # a head size the kernels take
    cpu, card = build_model(cfg, "cpu"), build_model(cfg, cuda)
    params = cpu.init(torch.Generator().manual_seed(0))
    on_card = _to(params, cuda)
    rng = np.random.default_rng(0)
    B, S = 2, 40
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    if cfg.is_encdec:
        kw = {"frames": torch.from_numpy(rng.standard_normal((B, 24, cfg.d_model),
                                                              dtype=np.float32))}
        P = 0
    else:
        P = cfg.num_frontend_tokens
        kw = {"patches": torch.from_numpy(rng.standard_normal((B, P, cfg.d_model),
                                                               dtype=np.float32))}
    lengths = torch.tensor([P + S, P + 23], dtype=torch.int32)
    card_in = (toks.to(cuda), lengths.to(cuda))
    card_kw = {k: v.to(cuda) for k, v in kw.items()}
    pre = make_prefill_fn(card)(on_card, *card_in, **card_kw)[1]
    assert float((pre.cpu() - make_prefill_fn(cpu)(params, toks, lengths, **kw)[1])
                 .abs().max()) < 1e-3
    n0 = (fa.launches, da.launches)
    got = make_generate_fn(card, 5)(on_card, *card_in, **card_kw)
    assert fa.launches > n0[0] and da.launches > n0[1]
    want = make_generate_fn(cpu, 5)(params, toks, lengths, **kw)
    assert torch.equal(got.cpu(), want)


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


@pytest.mark.gpu
def test_attention_wrappers_refuse_unaligned_rows(cuda):
    """Rows whose stride is not a multiple of 16 bytes cannot be copied 16
    bytes at a time: both wrappers raise ValueError."""
    B, H, K, T, d = 2, 4, 2, 64, 64
    for dt in (torch.float32, torch.bfloat16):
        wide = torch.zeros((B, K, T, d + 2), dtype=dt, device=cuda)
        k = wide[..., :d]                      # row stride (d + 2) elements
        q = torch.zeros((B, H, d), dtype=dt, device=cuda)
        lengths = torch.full((B,), T, dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match="16-byte"):
            da.decode_attention(q, k, k, lengths)
        with pytest.raises(ValueError, match="16-byte"):
            fa.flash_attention(torch.zeros((B, H, T, d), dtype=dt, device=cuda), k, k)
        shifted = torch.zeros(B * H * d + 1, dtype=dt, device=cuda)[1:].view(B, H, d)
        with pytest.raises(ValueError, match="16-byte"):
            da.decode_attention(shifted, k.contiguous(), k.contiguous(), lengths)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,R,shift,variant", [
    (4, 300, 4096, 0, {"float32": "ring", "bfloat16": "ring"}),   # S not a multiple of T
    (3, 1000, 300, 0, {"float32": "ring", "bfloat16": "register"}),  # 600 bytes a bf16 row
    (2, 17, 129, 0, {"float32": "register", "bfloat16": "register"}),
    (1, 0, 64, 0, {"float32": "register", "bfloat16": "register"}),   # within SMALL
    (3, 1, 4096, 0, {"float32": "register", "bfloat16": "register"}),  # S = 1
    (1, 333, 4096, 0, {"float32": "ring", "bfloat16": "ring"}),   # B = 1, 32-channel blocks
    (2, 1000, 256, 1, {"float32": "register", "bfloat16": "register"}),  # bases off 16 bytes
])
def test_rglru_kernel_matches_plain(cuda, dtype, B, S, R, shift, variant):
    """Both variants bitwise equal to the plain version: ragged S and R (no
    multiple of a stage or a block), S = 0 and 1, B = 1, and a and b viewed
    one element past a 16-byte boundary (past SMALL, so only the alignment
    sends it to the register body); bf16 a/b give bf16 states (fp32 inside)
    and an fp32 last state.  Each call takes the variant the plan names and
    launches once."""
    rng = np.random.default_rng(9)
    n = B * S * R + shift
    a = torch.from_numpy(rng.uniform(0.5, 0.999, n).astype(np.float32))
    b = torch.from_numpy(0.1 * rng.standard_normal(n, dtype=np.float32))
    a, b = (x.to(TORCH_DT[dtype]).to(cuda)[shift:].view(B, S, R) for x in (a, b))
    s0 = torch.from_numpy(rng.standard_normal((B, R), dtype=np.float32)).to(cuda)
    aligned = a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    assert aligned == (shift == 0 or B * S * R == 0)
    n0 = rg.launches
    seq, last = rg.rglru_scan(a, b, s0)
    torch.cuda.synchronize()
    assert rg.launches == n0 + 1
    assert rg.last_plan.variant == variant[dtype]
    sms = _build.sm_count(a.device.index)
    assert rg.last_plan == rg.plan(B, S, R, a.element_size(), sms, aligned=aligned)
    assert seq.dtype == a.dtype and last.dtype == torch.float32
    if S:
        want_seq, want_last = rg.plain(a, b, s0)
        assert torch.equal(seq, want_seq)
    else:
        want_last = s0
    assert torch.equal(last, want_last)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_ring_plans_match_plain(cuda, dtype):
    """The ring at plans other than the planner's (each block size, one
    stage, stages of a step count that divides nothing, the most stages;
    S = 1 and S = 0, which the planner gives the register body at these
    widths) stays bitwise, with the state carried across every stage
    boundary."""
    rng = np.random.default_rng(10)
    ring = rg.Plan("ring", 32, 1, 1)
    for (B, S, R), plans in (
            ((2, 1000, 4096), (rg.Plan("ring", 32, 7, 3), rg.Plan("ring", 128, 13, 1),
                               rg.Plan("ring", 128, 1, rg.MAX_STAGES),
                               rg.Plan("ring", 32, 128, 4))),
            ((3, 1, 4096), (ring, rg.Plan("ring", 128, 1, 2))), ((1, 0, 64), (ring,))):
        a = torch.from_numpy(rng.uniform(0.5, 0.999, (B, S, R)).astype(np.float32))
        b = torch.from_numpy(0.1 * rng.standard_normal((B, S, R), dtype=np.float32))
        a, b = (x.to(TORCH_DT[dtype]).to(cuda) for x in (a, b))
        s0 = torch.from_numpy(rng.standard_normal((B, R), dtype=np.float32)).to(cuda)
        want = rg.plain(a, b, s0) if S else (torch.empty_like(a), s0)
        for p in plans:
            got = rg.rglru_scan(a, b, s0, use=p)
            torch.cuda.synchronize()
            assert rg.last_plan == p
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), p


@pytest.mark.gpu
def test_rglru_ring_refuses_what_bulk_copies_cannot_take(cuda):
    """A ring plan handed a base off 16-byte alignment, or rows that are not
    a multiple of 16 bytes, raises: nothing falls back to the register body."""
    a = torch.zeros(2 * 8 * 256 + 1, device=cuda)[1:].view(2, 8, 256)
    s0 = torch.zeros((2, 256), device=cuda)
    ring = rg.Plan("ring", 32, 8, 2)
    with pytest.raises(RuntimeError, match="CUDA error"):
        rg.rglru_scan(a, a, s0, use=ring)
    r = torch.zeros((2, 8, 129), device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        rg.rglru_scan(r, r, torch.zeros((2, 129), device=cuda), use=ring)


@pytest.mark.gpu
@pytest.mark.parametrize("N", wk.HEAD_SIZES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H", [(2, 300, 4), (3, 17, 2), (1, 0, 1)])
def test_wkv6_kernel_matches_plain(cuda, dtype, B, S, H, N):
    """Ragged S (no multiple of a chunk), S = 0, both head sizes, and a
    planted fault (the bonus-u term dropped) that the check must reject."""
    rng = np.random.default_rng(10)

    def normal(shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))
    r, k = (normal((B, S, H, N), 0.5).to(TORCH_DT[dtype]).to(cuda) for _ in range(2))
    v = normal((B, S, H, N)).to(TORCH_DT[dtype]).to(cuda)
    logw = (-torch.exp(normal((B, S, H, N), 0.5))).to(cuda)
    u, s0 = normal((H, N), 0.1).to(cuda), normal((B, H, N, N), 0.1).to(cuda)
    n0 = wk.launches
    out, state = wk.wkv6(r, k, v, logw, u, s0)
    torch.cuda.synchronize()
    assert wk.launches == n0 + 1
    assert out.dtype == r.dtype and state.dtype == torch.float32
    want_out, want_state = wk.plain(r, k, v, logw, u, s0)
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 1e-3
    torch.testing.assert_close(out.float(), want_out.float(), atol=2e-4, rtol=rtol)
    torch.testing.assert_close(state, want_state, atol=2e-4, rtol=1e-3)
    if S:
        bad, _ = wk.wkv6(r, k, v, logw, torch.zeros_like(u), s0)
        with pytest.raises(AssertionError):
            torch.testing.assert_close(bad.float(), want_out.float(), atol=2e-4, rtol=rtol)


def wkv6_case(B, S, H, N, dtype, device, seed=10, logw_mean=0.0, logw_scale=0.5):
    rng = np.random.default_rng(seed)

    def normal(shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))
    r, k = (normal((B, S, H, N), 0.5).to(TORCH_DT[dtype]).to(device) for _ in range(2))
    v = normal((B, S, H, N)).to(TORCH_DT[dtype]).to(device)
    logw = (-torch.exp(logw_mean + normal((B, S, H, N), logw_scale))).to(device)
    return r, k, v, logw, normal((H, N), 0.1).to(device), normal((B, H, N, N), 0.1).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("N", wk.HEAD_SIZES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,S", [(1, 2, 31), (1, 2, 32), (1, 2, 33), (1, 2, 65),
                                   (16, 64, 63), (16, 64, 64), (16, 64, 65), (16, 64, 97),
                                   (1, 2, 63), (1, 2, 64), (1, 2, 127), (1, 2, 129),
                                   (16, 64, 127), (16, 64, 129), (2, 3, 1), (2, 3, 0)])
def test_wkv6_kernel_matches_float64_across_boundaries(cuda, dtype, B, H, S, N):
    """S at and on either side of a chunk boundary (32 and 64 for the
    tf32 kernel, 64 and 128 for the wgmma kernel in bf16 at N = 64) and of
    a segment boundary (one segment a chunk at B·H = 2, one segment in all
    for the wgmma kernel at B·H = 1024, segments of 2 and 3 chunks for the
    tf32 kernel there), one step, none: the chunked kernel against the
    plain recurrence in float64, within the limits above, the same bits on
    a second call."""
    args = wkv6_case(B, S, H, N, dtype, cuda, seed=S + N)
    P, Lc, chunk = wk.forward_plan(B, H, S, N, TORCH_DT[dtype])
    assert (P > 1) == (S > chunk and (B * H < wk.SMS or chunk == wk.BWD_CHUNK))
    out, state = wk.wkv6(*args)
    torch.cuda.synchronize()
    want_out, want_state = wk.plain(*args, acc=torch.float64)
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 1e-3
    torch.testing.assert_close(out.float(), want_out.float(), atol=2e-4, rtol=rtol)
    torch.testing.assert_close(state, want_state, atol=2e-4, rtol=1e-3)
    again = wk.wkv6(*args)
    assert torch.equal(out, again[0]) and torch.equal(state, again[1])


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,S,segments", [(4, 64, 1100, 1), (1, 64, 1100, 2),
                                            (1, 1, 4700, 74), (2, 3, 700, 11)])
def test_wkv6_wgmma_kernel_in_one_segment_and_in_many(cuda, B, H, S, segments):
    """The wgmma kernel (bf16, N = 64) at B·H that give one segment a
    (b, h) (B·H = 256 fills the card, as at rwkv6-7b's prefill) and many
    (the segment pass and the chain kernel run): within the float64 limits
    above, the same bits on a second call."""
    args = wkv6_case(B, S, H, 64, "bfloat16", cuda, seed=S + B)
    assert wk.plan_segments(B, H, S)[0] == segments
    out, state = wk.wkv6(*args)
    want_out, want_state = wk.plain(*args, acc=torch.float64)
    torch.testing.assert_close(out.float(), want_out.float(), atol=2e-4, rtol=2.0 ** -7)
    torch.testing.assert_close(state, want_state, atol=2e-4, rtol=1e-3)
    again = wk.wkv6(*args)
    assert torch.equal(out, again[0]) and torch.equal(state, again[1])


@pytest.mark.gpu
@pytest.mark.parametrize("N", wk.HEAD_SIZES)
def test_wkv6_kernel_extreme_decays_and_a_dropped_segment(cuda, N):
    """logw down to −exp(3) and beyond (chunk sums past −600, far outside
    fp32's exp range): finite and within the limits of the float64 plain
    version.  A second segment started from a zero state (k = 0 and
    e^{logw} = 0 on the first segment's last step) must fail the check."""
    B, S, H = 2, 300, 2
    r, k, v, logw, u, s0 = wkv6_case(B, S, H, N, "float32", cuda, seed=N, logw_mean=1.5,
                                     logw_scale=1.0)
    assert float(logw.min()) < -np.exp(3.0)
    out, state = wk.wkv6(r, k, v, logw, u, s0)
    want_out, want_state = wk.plain(r, k, v, logw, u, s0, acc=torch.float64)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(state).all())
    torch.testing.assert_close(out, want_out, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(state, want_state, atol=2e-4, rtol=1e-3)
    args = wkv6_case(B, S, H, N, "float32", cuda, seed=N)
    P, Lc, chunk = wk.forward_plan(B, H, S, N, torch.float32)
    assert P > 1
    want_out, _ = wk.plain(*args, acc=torch.float64)
    r, k, v, logw, u, s0 = args
    k, logw = k.clone(), logw.clone()
    k[0, Lc * chunk - 1], logw[0, Lc * chunk - 1] = 0.0, -200.0
    bad, _ = wk.wkv6(r, k, v, logw, u, s0)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(bad, want_out, atol=2e-4, rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_kernel_takes_views_off_16_byte_alignment(cuda, dtype):
    """r, k, v, logw and state0 as contiguous views one element into larger
    tensors (off the kernel's 16-byte alignment): the same result as on
    fresh tensors, bitwise."""
    args = wkv6_case(2, 70, 3, 32, dtype, cuda, seed=3)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        view = flat[1:].view(t.shape)
        view.copy_(t)
        return view
    r, k, v, logw, u, s0 = args
    views = (shifted(r), shifted(k), shifted(v), shifted(logw), u, shifted(s0))
    assert all(t.data_ptr() % 16 for t in views[:4] + views[5:])
    out, state = wk.wkv6(*views)
    want_out, want_state = wk.wkv6(*args)
    assert torch.equal(out, want_out) and torch.equal(state, want_state)


@pytest.mark.gpu
def test_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros((1, 2, 8, 96), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q[:, :1], q[:, :1])
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(torch.zeros((1, 2, 8, 64)), *(torch.zeros((1, 1, 8, 64),
                                                                     device=cuda),) * 2)


def quantized(M, K, N, seed, device):
    """int8 operands and their scales, quantized from numpy normals."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((K, N), dtype=np.float32))
    x_q, sx = ops.quantize_rowwise(x)
    w_q_t, sw = ops.quantize_rowwise(w.T)
    return tuple(t.contiguous().to(device) for t in (x_q, w_q_t.T, sx, sw))


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(4096, 9216, 2304), (257, 516, 100), (64, 512, 512),
                                   (1, 4, 1), (77, 130 * 4, 9)])
def test_int8_matmul_kernel_is_exact(cuda, M, K, N):
    """Bitwise equal to the exact plain version at an odd M, M and N not
    multiples of 64 or of 8, K not a multiple of the 64-byte K tile; within
    the calibration's tolerance of the dequantizing reference."""
    x_q, w_q, sx, sw = quantized(M, K, N, seed=M + N, device=cuda)
    n0 = i8.launches
    got = i8.int8_matmul(x_q, w_q, sx, sw)
    torch.cuda.synchronize()
    assert i8.launches == n0 + 1
    assert got.dtype == torch.float32 and got.shape == (M, N)
    assert torch.equal(got, i8.plain(x_q, w_q, sx, sw))
    want = ref.int8_matmul_reference(x_q, w_q, sx, sw)
    assert float((got - want).abs().max()) <= 2e-5 * max(1.0, float(want.abs().max()))
    # a planted fault: one 64-wide slice of K dropped must break equality
    x_f = x_q.clone()
    x_f[:, :min(K, 64)] = 0
    assert not torch.equal(i8.int8_matmul(x_f, w_q, sx, sw), got)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["row", "col"])
@pytest.mark.parametrize("M,K,N", [(77, 4, 9), (129, 36, 257), (300, 100, 130),
                                   (300, 9216, 257), (1, 4, 1)])
def test_int8_matmul_kernel_layouts_and_padded_k(cuda, layout, M, K, N):
    """w row-major (the transposing pass into scratch) and column-major (read
    in place where K is a multiple of 16), K not a multiple of 16 or 32
    (x and the scratch zero-padded), M and N not multiples of the 128 x 128
    tile: bitwise equal to the exact plain version, w left untouched; and
    where K is padded, the kernel handed operands whose padding is not zero
    rejected (with zeros there the same call is exact)."""
    x_q, w_q, sx, sw = quantized(M, K + 4, N, seed=M + K, device=cuda)
    x_q, w_q = x_q[:, :K].contiguous(), w_q[:K].contiguous()
    if layout == "col":
        w_q = w_q.T.contiguous().T
    w_before = w_q.clone()
    got = i8.int8_matmul(x_q, w_q, sx, sw)
    torch.cuda.synchronize()
    assert torch.equal(w_q, w_before) and w_q.stride() == w_before.stride()
    want = i8.plain(x_q, w_q, sx, sw)
    assert torch.equal(got, want)
    Kp = i8.padded_k(K)
    if Kp > K:
        def padded(a, fill):
            return torch.cat([a, torch.full((a.shape[0], Kp - K), fill, dtype=torch.int8,
                                            device=cuda)], 1)
        assert torch.equal(i8._launch(padded(x_q, 0), padded(w_q.T, 0), sx, sw, K, True), want)
        assert not torch.equal(i8._launch(padded(x_q, 3), padded(w_q.T, 5), sx, sw, K, True),
                               want)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["row", "col"])
def test_int8_matmul_kernel_at_max_k(cuda, layout):
    """K = MAX_K rounded down to a multiple of 4, with every operand at −128:
    the largest int32 sums the kernel promises, exact."""
    M, N, K = 3, 5, i8.MAX_K - i8.MAX_K % 4
    x_q = torch.full((M, K), -128, dtype=torch.int8, device=cuda)
    w_q = torch.full((K, N), -128, dtype=torch.int8, device=cuda)
    if layout == "col":
        w_q = w_q.T.contiguous().T
    sx = torch.linspace(0.5, 1.5, M, device=cuda)
    sw = torch.linspace(0.25, 2.0, N, device=cuda)
    got = i8.int8_matmul(x_q, w_q, sx, sw)
    assert torch.equal(got, i8.plain(x_q, w_q, sx, sw))
    assert float(got[0, 0]) == float(np.float32(np.float32(128 * 128 * K) * np.float32(0.5))
                                     * np.float32(0.25))


@pytest.mark.gpu
def test_kernel_records_verify_int8_on_the_card(cuda):
    from repro_torch.calibrate import kernel_records
    recs = kernel_records(["int8_matmul"], batches=(1, 2), seqs=(64,), repeats=1)
    assert len(recs) == 2
    assert all(r["backend"] == "hopper-kernel" and r["result"]["mode"] == "kernel-cuda"
               and r["result"]["max_err_vs_ref"] >= 0.0 for r in recs)


@pytest.mark.gpu
def test_new_kernel_wrappers_reject_what_they_do_not_take(cuda):
    x_q, w_q, sx, sw = quantized(32, 64, 16, seed=0, device=cuda)
    with pytest.raises(ValueError, match="card"):
        i8.int8_matmul(x_q.cpu(), w_q, sx, sw)
    with pytest.raises(ValueError, match="torch.int8 tensor"):
        i8.int8_matmul(x_q.float(), w_q, sx, sw)
    with pytest.raises(ValueError, match="multiple of 4"):
        i8.int8_matmul(x_q[:, :62], w_q[:62], sx, sw)
    a = torch.zeros((1, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="card"):
        rg.rglru_scan(a.cpu(), a.cpu(), a[:, 0].cpu())
    with pytest.raises(ValueError, match="not supported"):
        rg.rglru_scan(a.half(), a.half(), a[:, 0])
    with pytest.raises(ValueError, match="float32"):
        rg.rglru_scan(a.bfloat16(), a.bfloat16(), a[:, 0].bfloat16())
    r = torch.zeros((1, 4, 2, 32), device=cuda)
    args = (r, r, r, r, torch.zeros((2, 32), device=cuda),
            torch.zeros((1, 2, 32, 32), device=cuda))
    with pytest.raises(ValueError, match="card"):
        wk.wkv6(*(t.cpu() for t in args))
    with pytest.raises(ValueError, match="not supported"):
        wk.wkv6(*(t.half() for t in args[:3]), *args[3:])
    wide = torch.zeros((1, 4, 2, 96), device=cuda)   # above the largest head size, 64
    with pytest.raises(ValueError, match="head size"):
        wk.wkv6(wide, wide, wide, wide, torch.zeros((2, 96), device=cuda),
                torch.zeros((1, 2, 96, 96), device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("family", ("fc", "cnn", "lstm", "transformer"))
def test_generated_family_on_the_card_matches_its_cpu_run(cuda, family):
    from repro_torch.core import generator as gen
    spec = gen.GeneratedSpec(family, layers=3, width=128, batch=4, seq=16)
    model, (x,) = gen.build(spec, cuda)
    cpu_model, _ = gen.build(spec, "cpu")
    assert all(torch.equal(p.cpu(), q) for p, q in zip(model.parameters(),
                                                        cpu_model.parameters()))
    xs = torch.from_numpy(np.random.default_rng(0).standard_normal(
        tuple(x.shape), dtype=np.float32))
    with torch.inference_mode():
        got = model(xs.to(cuda)).cpu().double()
        want = cpu_model.double()(xs.double())
    assert got.shape == want.shape == (4, spec.num_classes)
    assert bool(((got - want).abs() <= 1e-5 + 1e-4 * want.abs()).all())


@pytest.mark.gpu
def test_measured_calibration_job_with_the_kernel_hook_on_the_card(cuda):
    from repro_torch.calibrate import run_calibration_job
    from repro_torch.core import CalibrationSpec
    spec = CalibrationSpec(job_id="hook", model={"kind": "generated", "family": "fc",
                                                 "layers": 2, "width": 64},
                           batches=(1, 2, 4), seqs=(64,), repeats=2,
                           kernels=("rglru_scan",))
    before = rg.launches
    res = run_calibration_job(spec)
    kernel_recs = [r for r in res.extra_records if r.get("backend") == "hopper-kernel"]
    assert res.metrics["mode"] == res.metrics["profile"]["source"] == "measured-cuda"
    assert all(r["result"]["mode"] == "measured-cuda" for r in res.extra_records
               if "backend" not in r)
    assert len(kernel_recs) == 3 * 2 and all(
        r["result"]["mode"] == "kernel-cuda" for r in kernel_recs)
    # per dtype: one verification, then per point a warm-up and 2 timed calls
    assert rg.launches - before == 2 * (1 + 3 * (1 + 2))


@pytest.mark.gpu
@pytest.mark.parametrize("family", ("fc", "cnn", "lstm", "transformer"))
def test_generated_job_on_the_card_stays_ieee_fp32_where_tf32_is_allowed(family, monkeypatch):
    """The session's measured forward of a generated model with PyTorch's
    flags left allowing TF32 (so not the ``cuda`` fixture, which turns it
    off): every forward runs with TF32 off, and its output is the same
    model's in float64 on the CPU within 1e-5 + 1e-4·|want|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import generator as gen
    from repro_torch.core.session import run_stages
    from repro_torch.core.spec import spec_from_dict
    seen, build = [], gen.build

    def spying_build(spec, device=None):
        model, inputs = build(spec, device)
        model.register_forward_hook(lambda m, args, out: seen.append(
            (spec, args[0].cpu(), out.cpu(), torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)))
        return model, inputs

    monkeypatch.setattr(gen, "build", spying_build)
    saved = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    try:
        res = run_stages(spec_from_dict({
            "job_id": family, "model": {"kind": "generated", "family": family,
                                        "layers": 2, "width": 128, "batch_hint": 4}}))
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]
    assert res.metrics["mode"] == "measured-cuda" and seen
    assert {r[3:] for r in seen} == {("highest", False)}
    spec, x, got = seen[0][:3]
    cpu_model, _ = build(spec, "cpu")
    with torch.inference_mode():
        want = cpu_model.double()(x.double())
    assert got.shape == want.shape == (4, spec.num_classes)
    assert bool(((got.double() - want).abs() <= 1e-5 + 1e-4 * want.abs()).all())


BWD_ATOL_SHARE = 2.0 ** -14    # chip_smoke.py's limit on K1's backward


def flash_bwd(q, k, v, dout, **opts):
    """K1′ on the forward's state from K1 on the same inputs."""
    state = fa.flash_attention(q, k, v, return_stats=True, **opts)[1:]
    return fa.flash_attention_bwd(q, k, v, dout, *state, **opts)


def held_grads(got, want):
    """Worst ratio of |got − want| to 2^-14·max|want| + 2^-7·|want| over
    (dq, dk, dv)."""
    return max(float(((g.double() - w).abs()
                       / (BWD_ATOL_SHARE * w.abs().max() + 2.0 ** -7 * w.abs())).max())
               for g, w in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opts", [dict(causal=True, window=48, softcap=50.0, scale=8.0),
                                  dict(causal=True, lengths=(200, 131, 5)),
                                  dict(causal=False, Sq=75)])
def test_flash_backward_matches_plain_grad(cuda, d, dtype, opts):
    """dQ, dK and dV of the kernel against autograd through the plain
    version in float64, with 4 query heads per kv head, ragged tiles, and a
    planted fault the check must reject: dK of the first head of each group
    only (the sum over the group dropped)."""
    opts = dict(opts)
    scale, Sq, lens = opts.pop("scale", 1.0), opts.pop("Sq", 200), opts.pop("lengths", None)
    B, H, K, S = 3, 8, 2, 200
    tq, tk, tv, do = arrays(7, dtype, (B, H, Sq, d), (B, K, S, d), (B, K, S, d), (B, H, Sq, d))
    tq, tk, tv, do = (t.to(cuda) for t in (tq * scale, tk, tv, do))
    if lens is not None:
        opts["lengths"] = torch.tensor(lens, dtype=torch.int32, device=cuda)
        for b, n in enumerate(lens):   # rows past a length carry no loss
            do[b, :, n:] = 0
    state = fa.flash_attention(tq, tk, tv, return_stats=True, **opts)[1:]
    n0 = fa.launches_bwd
    got = fa.flash_attention_bwd(tq, tk, tv, do, *state, **opts)
    torch.cuda.synchronize()
    assert fa.launches_bwd == n0 + 1
    want = fa.plain_grad(tq, tk, tv, do, acc=torch.float64, **opts)
    assert all(g.dtype == TORCH_DT[dtype] and g.shape == w.shape for g, w in zip(got, want))
    assert held_grads(got, want) <= 1.0
    one_head = flash_bwd(tq[:, ::H // K].contiguous(), tk, tv, do[:, ::H // K].contiguous(),
                         **opts)[1]
    assert held_grads((got[0], one_head, got[2]), want) > 10.0


@pytest.mark.gpu
def test_flash_attention_autograd_runs_both_kernels(cuda):
    """``ops.flash_attention`` on CUDA tensors that require a gradient: K1
    forward once, its backward kernel once, and the gradients the backward
    wrapper gives."""
    B, H, K, S, d = 2, 4, 2, 96, 64
    tq, tk, tv, do = (t.to(cuda).requires_grad_() for t in
                      arrays(8, "bfloat16", (B, H, S, d), (B, K, S, d), (B, K, S, d),
                             (B, H, S, d)))
    n0, m0 = fa.launches, fa.launches_bwd
    out = ops.flash_attention(tq, tk, tv, causal=True, softcap=30.0)
    grads = torch.autograd.grad(out, (tq, tk, tv), do.detach())
    assert (fa.launches, fa.launches_bwd) == (n0 + 1, m0 + 1)
    want = flash_bwd(tq.detach(), tk.detach(), tv.detach(), do.detach(), causal=True,
                     softcap=30.0)
    assert all(torch.equal(g, w) for g, w in zip(grads, want))


@pytest.mark.gpu
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
def test_flash_forward_keeps_its_bits_with_the_backward_state(cuda, d):
    """K1's bf16 output is the same bits with and without the state it
    hands the backward, and that state is its output before the bf16
    rounding (the bf16 output is its rounding) and each row's log-sum-exp
    (1e30 on rows with no live key)."""
    B, H, K, S = 2, 8, 2, 300
    tq, tk, tv = (t.to(cuda) for t in arrays(14, "bfloat16", (B, H, S, d), (B, K, S, d),
                                             (B, K, S, d)))
    opts = dict(causal=True, window=100, softcap=30.0,
                lengths=torch.tensor([300, 0], dtype=torch.int32, device=cuda))
    out, out32, lse = fa.flash_attention(tq, tk, tv, return_stats=True, **opts)
    assert torch.equal(out, fa.flash_attention(tq, tk, tv, **opts))
    assert torch.equal(out32.to(torch.bfloat16), out)
    assert lse.shape == (B, H, fa.stats_pitch(S)) and out32.shape == (B, H, S, d)
    assert bool((lse[1] == 1e30).all())
    s = (tq[:1].double() @ tk[:1].double().repeat_interleave(H // K, 1).transpose(-1, -2)
         / d ** 0.5)
    s = 30.0 * torch.tanh(s / 30.0)
    i, j = torch.arange(S, device=cuda)[:, None], torch.arange(S, device=cuda)[None, :]
    s = torch.where((j <= i) & (j > i - 100), s, -torch.inf)
    assert torch.allclose(lse[0, :, :S].double(), torch.logsumexp(s, -1), rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_kernels_without_a_backward_raise_on_a_gradient(cuda):
    """K2 and K5 on CUDA inputs that require a gradient raise, naming the
    missing backward; without grad mode they run.  (K3 and K4 have backward
    kernels: see test_recurrent_autograd_runs_both_kernels.)"""
    q = torch.randn((2, 4, 64), device=cuda, requires_grad=True)
    kv = torch.randn((2, 2, 32, 64), device=cuda)
    lengths = torch.full((2,), 32, dtype=torch.int32, device=cuda)
    x_q = torch.ones((16, 64), dtype=torch.int8, device=cuda)
    sx = torch.ones(16, device=cuda, requires_grad=True)
    calls = {"decode_attention": lambda: ops.decode_attention(q, kv, kv, lengths),
             "int8_matmul": lambda: ops.int8_matmul(x_q, x_q.T.contiguous(), sx,
                                                    torch.ones(16, device=cuda))}
    for name, call in calls.items():
        with pytest.raises(NotImplementedError, match=f"{name} has no backward kernel"):
            call()
        with torch.no_grad():
            call()


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,K,Sq,Skv,causal", [(4, 32, 8, 2048, 2048, True),
                                                 (4, 6, 6, 432, 1500, False)],
                         ids=["granite-3-2b", "whisper-tiny-cross-attention"])
def test_flash_backward_at_training_shapes(cuda, B, H, K, Sq, Skv, causal):
    """Two of ``chip_smoke.py`` phase 18's shapes (bf16, d 64), held one
    sequence at a time, with a planted fault of the kernel's own: the group
    sum dropped (granite) or keys read only up to Sq (whisper)."""
    d = 64
    tq, tk, tv, do = (t.to(cuda) for t in arrays(9, "bfloat16", (B, H, Sq, d), (B, K, Skv, d),
                                                 (B, K, Skv, d), (B, H, Sq, d)))
    got = flash_bwd(tq, tk, tv, do, causal=causal)
    if H > K:
        G = H // K
        fault = (got[0], flash_bwd(tq[:, ::G].contiguous(), tk, tv, do[:, ::G].contiguous(),
                                   causal=causal)[1],
                 got[2])
    else:
        cut = torch.full((B,), Sq, dtype=torch.int32, device=cuda)
        fault = flash_bwd(tq, tk, tv, do, causal=causal, lengths=cut)
    for b in range(B):
        want = fa.plain_grad(tq[b:b + 1], tk[b:b + 1], tv[b:b + 1], do[b:b + 1],
                             acc=torch.float64, causal=causal)
        assert held_grads([t[b:b + 1] for t in got], want) <= 1.0
        assert held_grads([t[b:b + 1] for t in fault], want) > 10.0



@pytest.mark.gpu
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_backward_is_bitwise_deterministic(cuda, d, dtype):
    """Two calls on the same inputs give the same bits in dq, dk and dv (no
    atomics: a bitwise restart of training needs this), with 4 query heads
    per kv head, a window and ragged lengths."""
    B, H, K, S = 2, 8, 2, 300
    tq, tk, tv, do = (t.to(cuda) for t in arrays(12, dtype, (B, H, S, d), (B, K, S, d),
                                                 (B, K, S, d), (B, H, S, d)))
    opts = dict(causal=True, window=100, softcap=30.0,
                lengths=torch.tensor([300, 171], dtype=torch.int32, device=cuda))
    state = fa.flash_attention(tq, tk, tv, return_stats=True, **opts)[1:]
    first = fa.flash_attention_bwd(tq, tk, tv, do, *state, **opts)
    second = fa.flash_attention_bwd(tq, tk, tv, do, *state, **opts)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.gpu
@pytest.mark.parametrize("window", [32, 64, 0])
def test_flash_backward_d256_window_on_tile_edges(cuda, window):
    """d = 256 in bf16 (the instantiation with 32-key tiles in the dQ
    kernel and 32-row query tiles in the dK/dV kernel), 16 query heads on
    one kv head, a window on a tile boundary of both kernels (32 and 64) and
    ragged lengths, held to the float64 plain version at chip_smoke.py
    phase 18's limit."""
    B, H, K, S, d = 3, 16, 1, 260, 256
    tq, tk, tv, do = (t.to(cuda) for t in arrays(13, "bfloat16", (B, H, S, d), (B, K, S, d),
                                                 (B, K, S, d), (B, H, S, d)))
    lens = (260, 97, 32)
    for b, n in enumerate(lens):   # rows past a length carry no loss
        do[b, :, n:] = 0
    opts = dict(causal=True, window=window,
                lengths=torch.tensor(lens, dtype=torch.int32, device=cuda))
    got = flash_bwd(tq, tk, tv, do, **opts)
    want = fa.plain_grad(tq, tk, tv, do, acc=torch.float64, **opts)
    assert held_grads(got, want) <= 1.0
    assert all(float(g[b, :, n:].abs().max()) == 0.0
               for g in got[1:] for b, n in enumerate(lens) if n < S)

def held_bwd(got, want):
    """Worst ratio of |got − want| to 2^-14·max|want| + one ulp of got's
    type (2^-7 bf16, 2^-23 fp32)·|want| over a backward's outputs."""
    worst = 0.0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if w.numel():
            ulp = 2.0 ** -7 if g.dtype == torch.bfloat16 else 2.0 ** -23
            limit = BWD_ATOL_SHARE * w.abs().max() + ulp * w.abs() + 1e-30
            worst = max(worst, float(((g.double() - w).abs() / limit).max()))
    return worst


def rglru_grad_inputs(seed, B, S, R, dtype, cuda):
    """a in (0.5, 0.999), b, s0, g and g_last normal: a/b/g in ``dtype``."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (B, S, R)).astype(np.float32)
    b = (0.1 * rng.standard_normal((B, S, R))).astype(np.float32)
    g = rng.standard_normal((B, S, R)).astype(np.float32)
    s0, g_last = (rng.standard_normal((B, R)).astype(np.float32) for _ in range(2))
    dt = TORCH_DT[dtype]
    return (torch.from_numpy(a).to(cuda, dt), torch.from_numpy(b).to(cuda, dt),
            torch.from_numpy(s0).to(cuda), torch.from_numpy(g).to(cuda, dt),
            torch.from_numpy(g_last).to(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,R", [(4, 2048, 4096), (3, 77, 100), (2, 1, 8), (2, 0, 8)])
def test_rglru_backward_kernel_matches_float64(cuda, dtype, B, S, R):
    """K3's backward against the plain version in float64, at
    recurrentgemma-9b's training shape and at ragged ones (a partial last
    chunk of 32 steps, one step, none), with a planted fault: g_last dropped."""
    a, b, s0, g, g_last = rglru_grad_inputs(11, B, S, R, dtype, cuda)
    n0 = rg.launches_bwd
    got = rg.rglru_scan_bwd(a, b, s0, g, g_last)
    torch.cuda.synchronize()
    assert rg.launches_bwd == n0 + 1
    assert [x.dtype for x in got] == [a.dtype, a.dtype, torch.float32]
    want = rg.plain_grad(a, b, s0, g, g_last, acc=torch.float64)
    assert held_bwd(got, want) <= 1.0
    if S:
        assert held_bwd(rg.rglru_scan_bwd(a, b, s0, g), want) > 10.0


def wkv_grad_inputs(seed, B, S, H, N, dtype, cuda):
    """r, k at 0.5 and v, dout at 1 normal in ``dtype``; logw = −exp(normal),
    u and state0 at 0.1 and dstate at 1 normal in fp32."""
    g = torch.Generator(device=cuda).manual_seed(seed)

    def normal(shape, scale=1.0):
        return scale * torch.randn(shape, generator=g, device=cuda)
    shape, dt = (B, S, H, N), TORCH_DT[dtype]
    r, k = normal(shape, 0.5).to(dt), normal(shape, 0.5).to(dt)
    v, logw = normal(shape).to(dt), -torch.exp(normal(shape))
    u, s0 = normal((H, N), 0.1), normal((B, H, N, N), 0.1)
    return r, k, v, logw, u, s0, normal(shape).to(dt), normal((B, H, N, N))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,B,S,H,N", [("bfloat16", 4, 2048, 64, 64),
                                           ("float32", 2, 300, 4, 32),
                                           ("bfloat16", 2, 300, 3, 64),
                                           ("float32", 1, 5, 2, 64),
                                           ("bfloat16", 2, 0, 2, 32),
                                           ("bfloat16", 4, 1, 64, 64),
                                           ("bfloat16", 4, 63, 64, 64),
                                           ("bfloat16", 4, 65, 64, 64),
                                           ("bfloat16", 4, 300, 64, 64)])
def test_wkv6_backward_kernel_matches_float64(cuda, dtype, B, S, H, N):
    """K4's backward against the plain version in float64, with a nonzero
    state0 and a gradient on the final state, at rwkv6-7b's training shape
    and at partial last chunks (bf16 at B·H = 256 takes the wgmma kernel:
    one step, a chunk of 64 less one, one more, and 300 steps); deterministic
    (a second call bitwise equal); a planted fault of its own must fail: u
    zeroed."""
    args = wkv_grad_inputs(12, B, S, H, N, dtype, cuda)
    n0 = wk.launches_bwd
    got = wk.wkv6_bwd(*args)
    torch.cuda.synchronize()
    assert wk.launches_bwd == n0 + 1
    assert [x.dtype for x in got] == [TORCH_DT[dtype]] * 3 + [torch.float32] * 3
    want = wk.plain_grad(*args, acc=torch.float64)
    assert held_bwd(got, want) <= 1.0
    assert all(torch.equal(x, y) for x, y in zip(got, wk.wkv6_bwd(*args)))
    if S:
        r, k, v, logw, u, s0, do, ds = args
        fault = wk.wkv6_bwd(r, k, v, logw, torch.zeros_like(u), s0, do, ds)
        assert held_bwd(fault, want) > 10.0


@pytest.mark.gpu
def test_recurrent_autograd_runs_both_kernels(cuda):
    """``ops.rglru_scan`` and ``ops.wkv6`` on CUDA tensors that require a
    gradient: the forward kernel once, the backward kernel once, and the
    gradients the backward wrappers give."""
    a, b, s0, g, g_last = (t.requires_grad_() for t in
                           rglru_grad_inputs(13, 2, 100, 64, "float32", cuda))
    n0 = (rg.launches, rg.launches_bwd)
    seq, last = ops.rglru_scan(a, b, s0)
    grads = torch.autograd.grad((seq, last), (a, b, s0), (g.detach(), g_last.detach()))
    assert (rg.launches, rg.launches_bwd) == (n0[0] + 1, n0[1] + 1)
    want = rg.rglru_scan_bwd(a.detach(), b.detach(), s0.detach(), g.detach(), g_last.detach())
    assert all(torch.equal(x, w) for x, w in zip(grads, want))
    r, k, v, logw, u, st, do, ds = wkv_grad_inputs(14, 2, 100, 2, 64, "bfloat16", cuda)
    xs = [t.requires_grad_() for t in (r, k, v, logw, u, st)]
    n0 = (wk.launches, wk.launches_bwd)
    out, state = ops.wkv6(*xs)
    grads = torch.autograd.grad((out, state), xs, (do, ds))
    assert (wk.launches, wk.launches_bwd) == (n0[0] + 1, n0[1] + 1)
    want = wk.wkv6_bwd(*(t.detach() for t in xs), do, ds)
    assert all(torch.equal(x, w) for x, w in zip(grads, want))


@pytest.mark.gpu
def test_wkv6_autograd_through_the_wgmma_backward(cuda):
    """``ops.wkv6`` under autograd at B·H = 256 in bf16: one forward launch,
    one backward launch on the wgmma kernel's route, the gradients those of
    ``wk.wkv6_bwd`` bitwise and within ``chip_smoke.py`` phase 19's limits of
    the float64 plain version."""
    cs = chip_smoke()
    r, k, v, logw, u, st, do, ds = wkv_grad_inputs(20, 4, 130, 64, 64, "bfloat16", cuda)
    assert wk.backward_plan(4, 64, 130, 64, torch.bfloat16) == (1, 3, wk.CHUNK)
    xs = [t.requires_grad_() for t in (r, k, v, logw, u, st)]
    n0 = (wk.launches, wk.launches_bwd)
    out, state = ops.wkv6(*xs)
    grads = torch.autograd.grad((out, state), xs, (do, ds))
    assert (wk.launches, wk.launches_bwd) == (n0[0] + 1, n0[1] + 1)
    args = [t.detach() for t in xs] + [do, ds]
    assert all(torch.equal(x, w) for x, w in zip(grads, wk.wkv6_bwd(*args)))
    want = wk.plain_grad(*args, acc=torch.float64)
    assert cs.held_bwd(grads, want, cs.wkv_bwd_limits(*args))[1] <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("N", [16, 8, 48])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_kernels_run_small_heads_padded(cuda, dtype, N):
    """A head of N outside ``HEAD_SIZES`` (rwkv6-7b's ~100M config has heads
    of 16) runs zero-padded to the next size: K4 within the tolerances of
    test_wkv6_kernel_matches_plain and K4′ within held_bwd's of their plain
    versions on the unpadded operands, one launch each."""
    B, S, H = 2, 300, 4
    args = wkv_grad_inputs(15, B, S, H, N, dtype, cuda)
    r, k, v, logw, u, s0, do, ds = args
    n0 = (wk.launches, wk.launches_bwd)
    out, state = wk.wkv6(r, k, v, logw, u, s0)
    got = wk.wkv6_bwd(*args)
    torch.cuda.synchronize()
    assert (wk.launches, wk.launches_bwd) == (n0[0] + 1, n0[1] + 1)
    assert out.shape == r.shape and state.shape == s0.shape
    want_out, want_state = wk.plain(r, k, v, logw, u, s0)
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 1e-3
    torch.testing.assert_close(out.float(), want_out.float(), atol=2e-4, rtol=rtol)
    torch.testing.assert_close(state, want_state, atol=2e-4, rtol=1e-3)
    assert held_bwd(got, wk.plain_grad(*args, acc=torch.float64)) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 31, 300, 2048])
@pytest.mark.parametrize("N", wk.HEAD_SIZES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_backward_kernel_gives_the_same_bits_twice(cuda, dtype, N, S):
    """K4′ over two calls, in one segment (S ≤ 32: one chunk) and in several
    (``wk.plan_bwd_segments`` cuts 300 and 2048 steps at B·H = 8): the
    same bits, as the trainer's bitwise restart needs, and within held_bwd
    of the float64 plain version."""
    args = wkv_grad_inputs(16, 2, S, 4, N, dtype, cuda)
    assert (wk.plan_bwd_segments(2, 4, S)[0] > 1) == (S > 32)
    got = wk.wkv6_bwd(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, wk.wkv6_bwd(*args)))
    assert held_bwd(got, wk.plain_grad(*args, acc=torch.float64)) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("N", wk.HEAD_SIZES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_backward_kernel_in_one_long_segment(cuda, dtype, N):
    """At B·H = 2048 the planner takes one segment of all ten chunks of 300
    steps: the kernel walks them in one block, the same bits twice, within
    held_bwd of the float64 plain version."""
    args = wkv_grad_inputs(17, 16, 300, 128, N, dtype, cuda)
    assert wk.plan_bwd_segments(16, 128, 300) == (1, 10)
    got = wk.wkv6_bwd(*args)
    assert all(torch.equal(x, y) for x, y in zip(got, wk.wkv6_bwd(*args)))
    assert held_bwd(got, wk.plain_grad(*args, acc=torch.float64)) <= 1.0


def chip_smoke():
    """``chip_smoke.py`` (at the repository root) as a module, for its
    limits."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,N", [("bfloat16", 64), ("float32", 32), ("float32", 16)])
def test_wkv6_backward_kernel_within_phase_19_limits(cuda, dtype, N):
    """K4′ at a small shape within ``chip_smoke.py`` phase 19's limits, which
    its tf32 arithmetic and its segments are derived into
    (``wkv_bwd_limits``)."""
    cs = chip_smoke()
    args = wkv_grad_inputs(18, 2, 300, 4, N, dtype, cuda)
    got = wk.wkv6_bwd(*args)
    want = wk.plain_grad(*args, acc=torch.float64)
    assert cs.held_bwd(got, want, cs.wkv_bwd_limits(*args))[1] <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,R", [(4, 2048, 4096), (1, 1000, 4096), (3, 333, 520)])
def test_rglru_backward_ring_equals_the_register_kernel(cuda, dtype, B, S, R):
    """K3′'s ring (at recurrentgemma-9b's training shape, at a batch of one
    on blocks of 32 channels, and with a partial last block and stage) and
    its register kernel give the same bits, which are the plain version's
    fp32 walk rounded to a's type."""
    args = rglru_grad_inputs(19, B, S, R, dtype, cuda)
    got = rg.rglru_scan_bwd(*args)
    assert rg.last_bwd_plan.variant == "ring"
    register = rg.rglru_scan_bwd(*args, use=rg.REGISTER)
    assert all(torch.equal(x, y) for x, y in zip(got, register))
    plain = rg.plain_grad(*args)
    assert all(torch.equal(x, y.to(x.dtype)) for x, y in zip(got, plain))
