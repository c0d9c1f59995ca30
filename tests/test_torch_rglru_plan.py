"""K3's planner, ``repro_torch.kernels.rglru_scan.plan``, on the CPU.

The planner chooses, before each launch, between the kernel's two variants
(a ring of bulk copies in shared memory, and the register body for shapes
bulk copies cannot take and for problems of at most ``SMALL`` elements) and
the ring's shape: C channels a block, T steps a stage, P stages.  These
tests hold it to what the kernel needs (rows of a multiple of 16 bytes, at
most 227 KB of shared memory a block) and to what the design asks (every
block resident in one wave on the H100's 132 SMs, the card covered at
B = 1).  The kernel itself runs only on a card:
``tests/test_torch_cuda.py`` holds both variants bitwise to the plain
version there.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.calibrate.kernel_bench import (DEFAULT_BATCHES,  # noqa: E402
                                                DEFAULT_SEQS, kernel_registry)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import rglru_scan as rg  # noqa: E402

SMS = rg.H100_SMS
R9B = get_config("recurrentgemma-9b").rglru_d_rnn   # 4096
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def resident(p, itemsize):
    """Blocks of plan p one SM holds at once."""
    by_smem = rg.SMEM_PER_SM // (p.smem_bytes(itemsize) + rg.SMEM_RESERVED)
    return min(rg.BLOCKS_PER_SM, rg.THREADS_PER_SM // p.threads(), by_smem)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S", [(4, 4700), (8, 512), (1, 4700), (1, 65)])
def test_ring_at_the_models_shapes(dtype, B, S):
    """recurrentgemma-9b's prefill (chip_smoke.py's B = 4 prompts padded to
    4700, and profile_step.py's batch 8 of 512), and a serving batch of one
    past ``SMALL``, take the ring in both types."""
    p = rg.plan(B, S, R9B, ITEMSIZE[dtype], SMS)
    assert p.variant == "ring"
    assert p.channels in rg.RING_CHANNELS and 1 <= p.steps <= rg.MAX_STEPS
    assert 1 <= p.stages <= rg.MAX_STAGES


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_covers_the_card_at_batch_one(dtype):
    """B = 1, R = 4096: 128 blocks of 32 channels (the register body, 128
    channels a block, gives 32 blocks)."""
    p = rg.plan(1, 4700, R9B, ITEMSIZE[dtype], SMS)
    assert (p.channels, p.blocks(1, R9B)) == (32, 128)
    assert rg.REGISTER.blocks(1, R9B) == 32


@pytest.mark.parametrize("R,itemsize", [(129, 4), (129, 2), (300, 2), (1001, 4), (4097, 2)])
def test_register_where_rows_are_not_16_byte_multiples(R, itemsize):
    assert (R * itemsize) % 16
    assert rg.plan(4, 300, R, itemsize, SMS) == rg.REGISTER


@pytest.mark.parametrize("R,itemsize", [(4096, 4), (4096, 2), (256, 4), (300, 4)])
def test_register_where_a_base_is_not_16_byte_aligned(R, itemsize):
    assert rg.plan(2, 1000, R, itemsize, SMS, aligned=False) == rg.REGISTER
    assert rg.plan(2, 1000, R, itemsize, SMS).variant == "ring"


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("B,S,R,variant", [
    (4, 256, 256, "register"), (4, 257, 256, "ring"), (1, 64, R9B, "register"),
    (1, 65, R9B, "ring"), (16, 4, R9B, "register"), (16, 5, R9B, "ring")])
def test_register_up_to_the_small_problem_threshold(itemsize, B, S, R, variant):
    """Problems of at most SMALL = 4 · 256 · 256 elements (the calibration
    grid's largest) take the register body, larger ones the ring."""
    assert (B * S * R <= rg.SMALL) == (variant == "register")
    assert rg.plan(B, S, R, itemsize, SMS).variant == variant


SHAPES = [(4, 4700, 4096), (1, 4700, 4096), (8, 512, 4096), (2, 77, 4096), (3, 1000, 300),
          (1, 64, 256), (4, 256, 256), (3, 1, 4096), (1, 0, 64), (16, 512, 4096),
          (2, 100000, 1024)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,R", SHAPES)
def test_ring_blocks_cover_R_and_fit_in_shared_memory(dtype, B, S, R):
    """The ring's blocks cover every channel of every batch row exactly once
    (the last block of a row may hold fewer), a stage holds T rows of a and
    of b, and a block's shared memory stays within 227 KB."""
    itemsize = ITEMSIZE[dtype]
    p = rg.plan(B, S, R, itemsize, SMS)
    if (R * itemsize) % 16 or B * S * R <= rg.SMALL:
        assert p == rg.REGISTER
        return
    per_row = p.blocks(1, R)
    assert (per_row - 1) * p.channels < R <= per_row * p.channels
    assert p.blocks(B, R) == B * per_row
    assert p.smem_bytes(itemsize) == (rg.BARRIER_BYTES
                                      + 2 * p.stages * p.steps * p.channels * itemsize)
    assert p.smem_bytes(itemsize) <= rg.SMEM_PER_BLOCK
    assert 2 * p.steps * p.channels * itemsize <= max(rg.STAGE_BYTES,
                                                      2 * p.channels * itemsize)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,R", [s for s in SHAPES if s[0] * s[2] <= 8 * 4096])
def test_ring_blocks_are_resident_in_one_wave(dtype, B, S, R):
    """Up to B·R = 8 × 4096 channels every block of the grid is resident at
    once on 132 SMs (blocks, threads and shared memory an SM holds)."""
    itemsize = ITEMSIZE[dtype]
    p = rg.plan(B, S, R, itemsize, SMS)
    if p.variant == "ring":
        assert p.blocks(B, R) <= SMS * resident(p, itemsize)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_keeps_bytes_in_flight_at_the_models_shape(dtype):
    """At recurrentgemma-9b's prefill shape the ring gives each SM at least
    32 KB of stages beyond the one being read: the loads in flight that the
    register body, at most 16 KB an SM in fp32, lacks."""
    itemsize = ITEMSIZE[dtype]
    p = rg.plan(4, 4700, R9B, itemsize, SMS)
    per_sm = -(-p.blocks(4, R9B) // SMS)
    in_flight = per_sm * (p.stages - 1) * 2 * p.steps * p.channels * itemsize
    assert p.stages >= 2 and in_flight >= 32 * 1024


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("S", [0, 1])
def test_empty_and_one_step_sequences_are_planned(itemsize, S):
    """S = 0 and S = 1 take the register body at the model's width (within
    SMALL); at S = 1 past SMALL (B = 8, R = 65536) a ring of one stage of
    one step."""
    assert rg.plan(2, S, R9B, itemsize, SMS) == rg.REGISTER
    p = rg.plan(8, S, 65536, itemsize, SMS)
    if S == 0:
        assert p == rg.REGISTER
    else:
        assert (p.variant, p.steps, p.stages) == ("ring", 1, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_calibration_grid_takes_the_register_body(dtype):
    """Every point of the calibration sweep (B ≤ 4, S ≤ 256, R = 256) is
    within SMALL and takes the register body, faster there per synchronised
    call."""
    case = kernel_registry()["rglru_scan"]
    for batch in DEFAULT_BATCHES:
        for seq in DEFAULT_SEQS:
            (a, _, _), _ = case.make(batch, seq, dtype, 0, "cpu")
            B, S, R = a.shape
            assert B * S * R <= rg.SMALL
            assert rg.plan(B, S, R, a.element_size(), SMS) == rg.REGISTER


def test_plan_follows_the_card():
    """The planner reads the card's SM count: on half the SMs, B = 1 still
    takes 32-channel blocks and B = 2 takes 128-channel ones where they
    cover the card as well."""
    assert rg.plan(1, 4700, R9B, 4, 66).channels == 32
    assert rg.plan(2, 4700, R9B, 4, 66).channels == 128
    assert rg.plan(2, 4700, R9B, 4, SMS).channels == 32


def bwd_smem(p, itemsize):
    """Dynamic shared memory of a backward ring block: the barriers, P
    stages of a, b and g, and the fp32 states of the stage walked back."""
    return (rg.BARRIER_BYTES + rg.BWD_TILES * p.stages * p.steps * p.channels * itemsize
            + 4 * p.steps * p.channels)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,R", [(4, 2048, R9B), (1, 2048, R9B), (8, 256, 1024), (3, 333, 520),
                                   (2, 1, 4096), (2, 256, 256), (4, 2048, 100)])
def test_backward_plan_takes_the_forwards_variant_and_ring_shape(dtype, B, S, R):
    """K3′'s planner takes K3's variant, C and T, and P stages of three
    tiles that fit a block's shared memory and, with the blocks an SM holds,
    the SM's."""
    itemsize = ITEMSIZE[dtype]
    fwd, bwd = rg.plan(B, S, R, itemsize, SMS), rg.plan_bwd(B, S, R, itemsize, SMS)
    assert (bwd.variant, bwd.channels, bwd.steps) == (fwd.variant, fwd.channels, fwd.steps)
    if bwd.variant == "register":
        assert bwd == rg.REGISTER
        return
    assert 1 <= bwd.stages <= min(rg.MAX_STAGES, max(-(-S // bwd.steps), 1))
    smem = bwd_smem(bwd, itemsize)
    per_sm = min(-(-(B * -(-R // bwd.channels)) // SMS), rg.BLOCKS_PER_SM,
                 rg.THREADS_PER_SM // bwd.threads())
    assert smem <= rg.SMEM_PER_BLOCK
    assert per_sm * (smem + rg.SMEM_RESERVED) <= rg.SMEM_PER_SM


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_ring_at_the_training_shape(dtype):
    """recurrentgemma-9b's training shape (B 4 × 2048): the ring, 128
    channels a block, two stages (as K3's forward there)."""
    p = rg.plan_bwd(4, 2048, R9B, ITEMSIZE[dtype], SMS)
    assert p == rg.Plan("ring", 128, 32 if dtype == "float32" else 64, 2)
    assert rg.plan_bwd(4, 2048, R9B, ITEMSIZE[dtype], SMS, aligned=False) == rg.REGISTER
