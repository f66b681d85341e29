"""The microbenchmark kernels of the torch port (iyokan_tpu_torch.ops.micro)
and its tools, against the JAX package's tools.

The Pallas kernels of tools/tk_mm_bench.py, tools/tk_width_bench.py and
tools/microbench.py are closures inside the tools, so a recorder stands in
for `jax.experimental.pallas.pallas_call`: each tool runs with small
arguments (BG 16, STEPS 2, BENCH_G 256, BENCH_INNER 3) until its first
kernel call, and the recorded kernels are then run in interpret mode on
seeded random inputs (the bodies that do not fix their shape at a smaller
one).  The port's wrappers run their plain twins on the same inputs (CPU
tensors), and the results must be equal, bit for bit.  Nothing under
tools/ or iyokan_tpu/ changes.  Also: each port tool's main under
IYOKAN_TORCH_DEVICE=cpu at tiny arguments, its refusal without a card and
without that variable, and (cuda-marked) each kernel == its twin on the
card.
"""

import importlib.util
import os
import re
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from iyokan_tpu_torch.ops import micro

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BG, STEPS, INNER = 16, 2, 3


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class _Stop(Exception):
    """Raised by a recorded kernel's stand-in call to end the tool's run."""


def _load(name, env):
    """tools/<name>.py as a fresh module, with env set while it imports."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        spec = importlib.util.spec_from_file_location(
            f"_jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


def _record(run):
    """[(kernel, pallas_call kwargs)] of the pallas_calls made by run()
    until the first call of a recorded kernel."""
    rec = []

    def fake(kernel, **kw):
        rec.append((kernel, kw))

        def call(*args):
            raise _Stop
        return call

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", fake)
        try:
            run()
        except _Stop:
            pass
    return rec


@pytest.fixture(scope="module")
def jax_kernels():
    """name -> (kernel, kwargs) of every Pallas kernel of T1-T3."""
    out = {}
    argv = sys.argv
    try:
        mm = _load("tk_mm_bench", {})
        sys.argv = ["tk_mm_bench.py", str(BG), str(STEPS), "1", "puret",
                    "pure", "fat", "thin"]
        for k, kw in _record(mm.main):
            out[k.__name__.replace("kern_", "")] = (k, kw)
        wb = _load("tk_width_bench", {})
        sys.argv = ["tk_width_bench.py", str(BG), str(STEPS), "1"]
        for name, rec in zip(WIDTH, _record(wb.main)):
            out[name] = rec
    finally:
        sys.argv = argv
    mb = _load("microbench", {"BENCH_G": "256", "BENCH_INNER": str(INNER),
                              "BENCH_ITERS": "2"})
    for case in ["mmp"] + [f"pk_{b}" for b in BODIES] + [
            "pk_mm", "pk_smallk", "pk_bdot"]:
        out[case] = _record(mb.CASES[case])[0]
    return out


WIDTH = {"w768": (6144, 768, 8), "w1536": (6144, 1536, 4),
         "w3072": (6144, 3072, 2), "w6144": (6144, 6144, 1),
         "k18432": (18432, 768, 8), "k3072": (3072, 768, 16)}
BODIES = tuple(micro.BODIES)


def _interpret(rec, *args, out_shape=None):
    kernel, kw = rec
    kw = {k: v for k, v in kw.items() if k != "compiler_params"}
    if out_shape is not None:
        kw["out_shape"] = out_shape
    call = pl.pallas_call(kernel, interpret=True, **kw)
    return np.asarray(jax.jit(call)(*[jnp.asarray(a) for a in args]))


def _i8(rng, shape):
    return rng.integers(-128, 128, shape, dtype=np.int8)


def _t(a):
    """numpy -> CPU tensor; uint32 as its int32 bit pattern."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _alu_inputs(body, rng):
    """numpy operands of pk_<body> at [4, 8 | 2, 1024] (u32 as uint32)."""
    ins = [t.numpy() for t in micro.alu_operands(body, "cpu", rng, rows=4)]
    if body in ("roll", "select"):
        ins = [a.view(np.uint32) for a in ins]
    return ins


CASES = ([f"T1 {m}" for m in micro.MODES] + [f"T2 {w}" for w in WIDTH]
         + ["T3a mmp", "T3c pk_mm", "T3d pk_smallk", "T3e pk_bdot"]
         + [f"T3b {b}" for b in BODIES])


@pytest.mark.parametrize("case", CASES)
def test_twin_equals_jax_tool_kernel(case, jax_kernels):
    """Each port twin == the JAX tool's Pallas kernel in interpret mode."""
    group, name = case.split()
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    if group == "T1":
        x = _i8(rng, (BG, 6, 2048) if name == "thin" else (BG, 12288))
        rhs = _i8(rng, {"thin": (1024, 768), "puret": (768, 6144)}.get(
            name, (6144, 768)))
        want = _interpret(jax_kernels[name], x, rhs)
        got, chk = micro.tk_loop(_t(x), _t(rhs), STEPS, name)
        assert chk.shape == (BG,) and chk.dtype == torch.int32
    elif group == "T2":
        K, NO, nd = WIDTH[name]
        x = _i8(rng, (BG, K + 128 * nd))
        rhs = _i8(rng, (K, NO))
        want = _interpret(jax_kernels[name], x, rhs)
        got, chk = micro.width_loop(_t(x), _t(rhs), STEPS, nd)
        assert chk.shape == (BG,)
    elif name == "mmp":                  # one step over 6 * 256 rows
        a, b = _i8(rng, (1536, 1024)), _i8(rng, (1024, 1024))
        want = _interpret(jax_kernels[name], a, b)
        got = micro.mm_mask(_t(a), _t(b), 127, 1)
    elif name == "pk_mm":                # the body at 32 of its 3072 rows
        a, b = _i8(rng, (32, 1024)), _i8(rng, (1024, 1024))
        want = _interpret(jax_kernels[name], a, b,
                          out_shape=jax.ShapeDtypeStruct(a.shape, jnp.int8))
        got = micro.mm_mask(_t(a), _t(b), 127, INNER)
    elif name == "pk_smallk":            # its own shape: Y is fixed
        a, w = _i8(rng, (8, 3072, 128)), _i8(rng, (8, 8))
        want = _interpret(jax_kernels[name], a, w)
        got = micro.smallk_loop(_t(w), _t(a), INNER)
    elif name == "pk_bdot":              # 32 of its 768 rows a batch
        a, w = _i8(rng, (8, 32, 128)), _i8(rng, (8, 128, 128))
        want = _interpret(jax_kernels[name], a, w,
                          out_shape=jax.ShapeDtypeStruct(a.shape, jnp.int8))
        got = micro.mm_mask(_t(a), _t(w), 63, INNER)
    else:                                # the body on [4, 8 | 2, 1024]
        ins = _alu_inputs(name, rng)
        want = _interpret(jax_kernels[f"pk_{name}"], *ins,
                          out_shape=jax.ShapeDtypeStruct(ins[0].shape,
                                                         ins[0].dtype))
        got = micro.alu_loop(_t(ins[0]), name, INNER,
                             *[_t(e) for e in ins[1:]])
    got = got.numpy()
    if want.dtype == np.uint32:
        want = want.view(np.int32)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want), (case, np.argwhere(got != want)[:5])


# --------------------------------------------------------------------------- #
# the port's tools
# --------------------------------------------------------------------------- #

TOOLS = {
    "tk_mm_bench": (["16", "1", "1", "puret", "pure", "fat", "thin"], {}),
    "tk_width_bench": (["16", "1", "1", "w768", "w6144", "k3072"], {}),
    "microbench": (["mm", "mmp", "vpu", "barrett", "rot", "decomp",
                    "pk_f32", "pk_roll", "pk_smallk", "pk_bdot",
                    "tkey_step"],
                   {"BENCH_G": "16", "BENCH_ITERS": "1", "BENCH_INNER": "1"}),
}


def _tool(name):
    return importlib.import_module(f"iyokan_tpu_torch.tools.{name}")


@pytest.mark.parametrize("name", TOOLS)
def test_tool_runs_on_cpu_when_asked(name, monkeypatch, capsys):
    """Each tool's main at tiny arguments under IYOKAN_TORCH_DEVICE=cpu
    (the twins): one line per case, in the JAX tool's format."""
    argv, env = TOOLS[name]
    monkeypatch.setenv("IYOKAN_TORCH_DEVICE", "cpu")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _tool(name).main(argv)
    out = capsys.readouterr().out
    if name == "tk_mm_bench":
        assert out.count("us/step") == 4 and out.count("compile") == 4
    elif name == "tk_width_bench":
        assert [ln.split()[0] for ln in out.splitlines()] == [
            "w768", "w6144", "k3072"]
        assert out.count("TMAC/s") == 3
    else:
        assert out.startswith("# G=16 iters=1 inner=1 device=cpu")
        for line in ("mm_int8 pallas", "pk_f32 11 ops", "pk_roll+negmask",
                     "pk_smallk [8,8]", "pk_bdot", "tkey step L=3 BG=16",
                     "rot_poly", "decompose1", "center_reduce"):
            assert line in out, line


@pytest.mark.parametrize("name", TOOLS)
def test_tool_needs_a_card_or_the_cpu_variable(name, monkeypatch):
    """Without a card and without IYOKAN_TORCH_DEVICE each tool raises
    before it computes anything: no silent CPU fallback."""
    monkeypatch.delenv("IYOKAN_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="IYOKAN_TORCH_DEVICE"):
        _tool(name).main(TOOLS[name][0])


def test_microbench_refuses_the_unported_cases():
    mb = _tool("microbench")
    for case in ("fwd", "pw", "inv", "crt"):
        with pytest.raises(ValueError, match="not ported"):
            mb.main([case])


def test_timing_marginal_is_the_difference_method(monkeypatch):
    """timing.marginal(run, n) = (t(run(4n)) - t(run(n))) / 3n with each t
    the minimum of 3 timed calls: a fake clock that advances 2 ms a unit
    plus 5 ms a call gives 2 ms a unit (the fixed cost cancels)."""
    from iyokan_tpu_torch.tools import timing
    clock = [0.0]
    monkeypatch.setattr(timing.time, "perf_counter", lambda: clock[0])

    def run(n):
        clock[0] += 5e-3 + 2e-3 * n
    assert timing.marginal(run, 10, "cpu") == pytest.approx(2e-3, abs=1e-12)
    assert timing.timed_ms(lambda: run(1), 4, "cpu") == pytest.approx(7.0)


def test_loop_kernel_l2_bytes_per_step():
    """The looped kernel's L2 traffic a step, at T1 fat BG 512: 32 M tiles
    (8 windows x 4) x 6 column tiles, each bringing 48 k-tiles of a
    128-row A tile and a 128-row B tile, 128 bytes deep."""
    x = torch.zeros((512, 12288), dtype=torch.int8)
    cfg = micro.tk_config(x, torch.zeros((6144, 768), dtype=torch.int8),
                          "fat")
    assert micro.l2_bytes_per_step(cfg) == 32 * 6 * 48 * (128 + 128) * 128


def _z(*shape):
    return torch.zeros(shape, dtype=torch.int8)


# every looped-product shape the tools run on the card (T1 at BG 512 and
# 2048, T2's cases at BG 512, T3's matrix cases at G 1024)
TOOL_SHAPES = (
    [(f"tk_loop {m} BG={bg}", lambda m=m, bg=bg: micro.tk_config(
        _z(bg, 6, 2048) if m == "thin" else _z(bg, 12288),
        _z(*{"thin": (1024, 768), "puret": (768, 6144)}.get(m, (6144, 768))),
        m)) for bg in (512, 2048) for m in micro.MODES]
    + [(f"width_loop {n}", lambda k=k, no=no, nd=nd: micro.width_config(
        _z(512, k + 128 * nd), _z(k, no), nd))
       for n, (k, no, nd) in WIDTH.items()]
    + [(f"mm_mask {a}", lambda a=a, b=b: micro.mm_config(_z(*a), _z(*b), 63))
       for a, b in (((6144, 1024), (1024, 1024)), ((3072, 1024), (1024, 1024)),
                    ((8, 768, 128), (8, 128, 128)))])


@pytest.mark.parametrize("name,cfg", TOOL_SHAPES,
                         ids=[n for n, _ in TOOL_SHAPES])
def test_step_plan_covers_the_card(name, cfg):
    """At every tool shape the step grid gives at least one CTA per SM
    (132 on the H100), with the tiles the kernel takes: TILE 128 columns
    and no split, MM no split, a split of at most the k-tiles."""
    c = cfg()
    pl = micro.step_plan(c)
    assert pl["ctas"] >= micro.SMS, (name, pl)
    assert c["NO"] % pl["bn"] == 0 and pl["bn"] in (32, 64, 128, 256)
    assert pl["split"] <= pl["k_tiles"] and pl["split"] & (pl["split"] - 1) == 0
    if c["mode"] != 1:
        assert pl["split"] == 1
    if c["mode"] == 0:
        assert pl["bn"] == 128


# --------------------------------------------------------------------------- #
# CPU models of the kernels' register layouts (csrc/micro.cu)
# --------------------------------------------------------------------------- #

# the PTX ISA's fragment tables of mma.sync m16n8k16 / m16n8k32 with s8
# operands (GR = 2 / 4 registers of A), for lane (g, q) = (lane / 4,
# lane % 4): A row-major 16 x 8GR, B column-major 8GR x 8, C s32 16 x 8


def _a_pos(g, q, r, b):
    """(row, k) of byte b of A register r."""
    return g + 8 * (r % 2), 16 * (r // 2) + 4 * q + b


def _b_pos(g, q, s, b):
    """(k, n) of byte b of B register s."""
    return 16 * s + 4 * q + b, g


def _c_pos(g, q, i):
    """(row, n) of C element i."""
    return g + 8 * (i // 2), 2 * q + i % 2


def _smallk_pi(GR):
    """{C column 8 nt + n: A column} of the kernel's repacking: element
    i = 2h + e of n-tile nt goes to byte 2 (nt % 2) + e of A register
    2 (nt / 2) + h, in the same lane; raises unless every lane and row
    agrees on the row and the column."""
    pi = {}
    for lane in range(32):
        g, q = lane // 4, lane % 4
        for nt in range(GR):
            for i in range(4):
                row, n = _c_pos(g, q, i)
                h, e = i // 2, i % 2
                arow, k = _a_pos(g, q, 2 * (nt // 2) + h, 2 * (nt % 2) + e)
                assert arow == row, (lane, nt, i)
                assert pi.setdefault(8 * nt + n, k) == k, (lane, nt, i)
    return pi


@pytest.mark.parametrize("GR", (2, 4))
def test_smallk_fragment_permutation_is_a_bijection(GR):
    """The repacking pi of smallk_kernel<GR> takes every C column of a
    row to one A column of the same row in the same lane, one to one, so
    a round's results become the next round's A fragment with no
    shuffle."""
    pi = _smallk_pi(GR)
    assert sorted(pi) == list(range(8 * GR))
    assert sorted(pi.values()) == list(range(8 * GR))


def _smallk_model(w, a, inner, mask, GR, TW=2):
    """smallk_kernel<GR, TW>'s schedule in torch: tiles of 16 rows x 8 GR
    bytes, A column pi(8 g + c) holding component c of group g (the
    column y = 16 GR tile + 16 g + row), B the block diagonal of W^T with
    its rows permuted by pi and built as the kernel builds its registers,
    a round [rows, 8 GR] x [8 GR, 8 GR] then the low byte of each sum &
    mask back in pi order."""
    pi = _smallk_pi(GR)
    K = 8 * GR
    group = {k: c // 8 for c, k in pi.items()}
    comp = {k: c % 8 for c, k in pi.items()}
    # B as the kernel loads it: register s of n-tile nt, byte b, lane (g, q)
    # holds W[g][2q + b % 2] where group 2s + b / 2 is nt
    B = torch.zeros((K, K), dtype=torch.int64)
    for lane in range(32):
        g, q = lane // 4, lane % 4
        for nt in range(GR):
            for s in range(GR // 2):
                for b in range(4):
                    k, n = _b_pos(g, q, s, b)
                    if 2 * s + b // 2 == nt:
                        B[k, 8 * nt + n] = int(w[g, 2 * q + b % 2])
    # ... which is the block diagonal of W^T with rows permuted by pi
    want_b = torch.zeros((K, K), dtype=torch.int64)
    for k in range(K):
        for c in range(K):
            if group[k] == c // 8:
                want_b[k, c] = int(w[c % 8, comp[k]])
    assert torch.equal(B, want_b)
    a = a.reshape(8, -1).to(torch.int64)
    Y = a.shape[1]
    tiles = -(-Y // (16 * GR * TW)) * TW
    A = torch.zeros((16 * tiles, K), dtype=torch.int64)
    y = torch.tensor([[16 * GR * (r // 16) + 16 * group[k] + r % 16
                       for k in range(K)] for r in range(16 * tiles)])
    cmp = torch.tensor([comp[k] for k in range(K)]).expand_as(y)
    live = y < Y
    A[live] = a[cmp[live], y[live]]
    order = torch.tensor([pi[c] for c in range(K)])
    for _ in range(inner):
        C = A @ B
        nxt = torch.empty_like(A)
        nxt[:, order] = micro._wrap(C & mask, 8)
        A = nxt
    out = torch.zeros((8, Y), dtype=torch.int64)
    out[cmp[live], y[live]] = A[live]
    return out.to(torch.int8)


@pytest.mark.parametrize("GR", (2, 4))
@pytest.mark.parametrize("mask", (63, 127, 255))
def test_smallk_schedule_model_equals_twin(GR, mask):
    """The kernel's schedule (fragment layout, permuted B, repacking) ==
    smallk_loop_ref, at inner 0, 1, 2, 5 and a Y that fills no tile."""
    rng = np.random.default_rng(GR * 1000 + mask)
    w = _t(_i8(rng, (8, 8)))
    for Y in (16 * 8 * GR + 13, 5):
        a = _t(_i8(rng, (8, Y)))
        for inner in (0, 1, 2, 5):
            got = _smallk_model(w, a, inner, mask, GR)
            assert torch.equal(got, micro.smallk_loop_ref(w, a, inner,
                                                          mask)), (Y, inner)


def _roll_model(x, m, inner):
    """roll_kernel's renaming in torch: thread t of a row keeps word t +
    ROLL_SHIFT j in register j; before round k register j holds slot (j +
    k) mod P (P = ROLL_PERIOD) and a round is v[j] = v[j] c[(j + k + 1)
    mod P] + 1 with c[s] = 1 - 2 m[t + ROLL_SHIFT s]; the rounds run P at
    a time, the rest after; register j is stored at slot (j + inner) mod
    P."""
    P, S = micro.ROLL_PERIOD, micro.ROLL_SHIFT
    M32 = micro.MASK32
    xs = x.reshape(-1, P, S).to(torch.int64) & M32    # [row, slot, t]
    c = (1 - 2 * (m.reshape(P, S).to(torch.int64) & M32)) & M32
    v = [xs[:, j] for j in range(P)]
    full = inner - inner % P
    for k in list(range(0, full, P)) + [full]:
        for r in range(P if k < full else inner - full):
            v = [(v[j] * c[(j + r + 1) % P] + 1) & M32 for j in range(P)]
    out = torch.empty_like(xs)
    slots = [(j + inner) % P for j in range(P)]
    assert sorted(slots) == list(range(P))          # every word stored once
    for j in range(P):
        out[:, slots[j]] = v[j]
    return micro._wrap(out.reshape(x.shape)).to(torch.int32)


def test_roll_renaming_model_equals_twin():
    """roll_kernel's register renaming == the twin (torch.roll each round)
    for inner 0..17, two periods and a remainder, on random words and a
    random mask (not only 0/1)."""
    rng = np.random.default_rng(17)
    x = _t(rng.integers(-2**31, 2**31, (3, 2, 1024), dtype=np.int32))
    for m in (_t(rng.integers(0, 2, (1, 1, 1024), dtype=np.int32)),
              _t(rng.integers(-2**31, 2**31, (1, 1, 1024), dtype=np.int32))):
        for inner in range(18):
            assert torch.equal(_roll_model(x, m, inner),
                               micro.alu_loop_ref(x, "roll", inner, m)), inner


def test_kernel_constants_match_the_source():
    """ops/micro.py's copies of csrc/micro.cu's layout constants (the
    chip run divides SASS counts by them; the tests pick round counts off
    the unrolling by them) are the source's."""
    src = open(os.path.join(ROOT, "iyokan_tpu_torch", "csrc",
                            "micro.cu")).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("ALU_U") == micro.ALU_UNROLL
    assert const("ROLL_SHIFT") == micro.ROLL_SHIFT
    assert const("ROLL_N") // const("ROLL_SHIFT") == micro.ROLL_PERIOD
    assert const("SK_GR") == micro.SMALLK_GROUPS


def test_micro_forms_spec_edits_the_source(tmp_path):
    """tools/micro_forms.json (micro_variants' comparison of the loops'
    forms): every variant's edits match csrc/micro.cu, each on its own
    copy of csrc/, and a variant without edits is csrc/ itself."""
    from iyokan_tpu_torch.ops import nvcc
    from iyokan_tpu_torch.tools import br_variants
    spec = br_variants.load_spec(os.path.join(
        ROOT, "iyokan_tpu_torch", "tools", "micro_forms.json"))
    dirs = dict(br_variants.prepare(spec, str(tmp_path), cumulative=False))
    base = open(os.path.join(nvcc.CSRC, "micro.cu")).read()
    for name, edits in spec.items():
        if not edits:
            assert dirs[name] == nvcc.CSRC
            continue
        text = open(os.path.join(dirs[name], "micro.cu")).read()
        assert text != base, name
        want = base
        for _, pat, rep in edits:
            want = re.sub(pat, rep, want)
        assert text == want, name


def test_float_round_by_magic_add_is_round_half_even():
    """alu_kernel's round of |f| < 2^22 (barrett, conv): the bits of f +
    1.5 * 2^23 less 0x4B400000 == round half to even, at ties, near the
    range's ends and on the bodies' own products x * f32(1/p)."""
    rng = np.random.default_rng(9)
    x = rng.integers(-2**31, 2**31, 200000, dtype=np.int64)
    f = np.concatenate([
        x.astype(np.float32) * np.float32(1.0 / micro.BARRETT_P),
        x.astype(np.float32) * np.float32(2.0 ** -10),   # micro_alu's limit
        np.arange(-40, 41, dtype=np.float32) / 2,        # ties
        np.float32([2**22 - 0.5, -2**22 + 0.5, 2**21 + 0.5, -0.0])])
    assert np.abs(f).max() < 2**22
    s = (f + np.float32(12582912.0)).astype(np.float32)
    got = (s.view(np.uint32).astype(np.int64) - 0x4B400000)
    assert np.array_equal(got, np.round(f).astype(np.int64))


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")


def _both(fn, *args):
    """fn on the card and on the CPU (the twin), as CPU tensors."""
    got = fn(*[a.cuda() if isinstance(a, torch.Tensor) else a
               for a in args])
    torch.cuda.synchronize()
    want = fn(*args)
    return got, want


def _same(got, want):
    if isinstance(got, tuple):
        return all(_same(g, w) for g, w in zip(got, want))
    return torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", micro.MODES)
def test_tk_loop_kernel_equals_twin_on_card(mode):
    _card()
    rng = np.random.default_rng(len(mode))
    x = _t(_i8(rng, (48, 6, 2048) if mode == "thin" else (48, 12288)))
    rhs = _t(_i8(rng, {"thin": (1024, 768), "puret": (768, 6144)}.get(
        mode, (6144, 768))))
    key = micro.launch_key("tk_loop", mode, 48)
    before = micro.LAUNCHES[key]
    assert _same(*_both(micro.tk_loop, x, rhs, 3, mode))
    assert micro.LAUNCHES[key] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", WIDTH)
def test_width_loop_kernel_equals_twin_on_card(name):
    _card()
    K, NO, nd = WIDTH[name]
    rng = np.random.default_rng(K + NO)
    x, rhs = _t(_i8(rng, (32, K + 128 * nd))), _t(_i8(rng, (K, NO)))
    assert _same(*_both(micro.width_loop, x, rhs, 2, nd))


@pytest.mark.cuda
def test_matrix_kernels_equal_twins_on_card():
    _card()
    rng = np.random.default_rng(5)
    a, b = _t(_i8(rng, (96, 1024))), _t(_i8(rng, (1024, 1024)))
    for inner in (0, 1, 2, 5):
        assert _same(*_both(micro.mm_mask, a, b, 127, inner))
    a, w = _t(_i8(rng, (8, 48, 128))), _t(_i8(rng, (8, 128, 128)))
    assert _same(*_both(micro.mm_mask, a, w, 63, 3))
    a, w = _t(_i8(rng, (8, 40, 128))), _t(_i8(rng, (8, 8)))
    assert _same(*_both(micro.smallk_loop, w, a, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("body", BODIES)
def test_alu_kernel_equals_twin_on_card(body):
    """Each body's kernel == its twin at round counts on and off the
    kernel's unrolling (ALU_UNROLL; roll: ROLL_PERIOD)."""
    _card()
    ins = [_t(a) for a in _alu_inputs(body, np.random.default_rng(7))]
    U = micro.ROLL_PERIOD if body == "roll" else micro.ALU_UNROLL
    for inner in (0, 1, U - 1, U, U + 1, 2 * U + 3):
        assert _same(*_both(micro.alu_loop, ins[0], body, inner,
                            *ins[1:])), inner


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ((8, 1000), (8, 3, 37), (8, 3072, 128)))
def test_smallk_kernel_equals_twin_on_card(shape):
    """The mma.sync small-K loop == its twin at round counts on and off its
    unrolling, at Y = 1000 and 111 (tails of its 64-column warps) and
    pk_smallk's own 393,216, for the masks 63, 127 and 255."""
    _card()
    rng = np.random.default_rng(shape[1])
    w, a = _t(_i8(rng, (8, 8))), _t(_i8(rng, shape))
    for mask in (63, 127, 255):
        for inner in (0, 1, 2, 3, 7):
            assert _same(*_both(micro.smallk_loop, w, a, inner, mask)), (
                mask, inner)


@pytest.mark.cuda
def test_alu_kernel_refuses_what_its_layout_does_not_take():
    """16 bytes a thread: a body whose elements are not a multiple of 16
    bytes raises on the card (the twin takes any shape), as do a roll row
    of other than 1024 words and a shift other than 128."""
    _card()
    x = torch.ones(6, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="16 bytes"):
        micro.alu_loop(x, "vpu", 3)
    with pytest.raises(ValueError, match="1024"):
        micro.alu_loop(torch.ones((2, 512), dtype=torch.int32,
                                  device="cuda"), "roll", 3,
                       torch.ones(512, dtype=torch.int32, device="cuda"))
    # roll_kernel's renaming is built for ROLL_SHIFT = 128 alone
    x = torch.ones((2, 1024), dtype=torch.int32, device="cuda")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(micro, "ROLL_SHIFT", 64)
        with pytest.raises(RuntimeError, match="micro_alu launch failed"):
            micro.alu_loop(x, "roll", 3, torch.ones_like(x[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("name,cfg", TOOL_SHAPES,
                         ids=[n for n, _ in TOOL_SHAPES])
def test_loop_kernel_equals_twin_at_tool_shapes(name, cfg):
    """Each looped product == its twin, both on the card, at the tools' own
    shapes (2 steps or rounds), on seeded random inputs."""
    _card()
    rng = np.random.default_rng(len(name))
    fn, args = name.split()[0], cfg()
    if fn == "tk_loop":
        mode = name.split()[1]
        x = _i8(rng, (args["rows"], 6, 2048) if mode == "thin"
                else (args["rows"], 12288))
        rhs = _i8(rng, (768, 6144) if mode == "puret"
                  else (args["seglen"], 768))
        kern, ref, extra = micro.tk_loop, micro.tk_loop_ref, (2, mode)
    elif fn == "width_loop":
        nd = args["nwin"]
        x = _i8(rng, (512, args["seglen"] + 128 * nd))
        rhs = _i8(rng, (args["seglen"], args["NO"]))
        kern, ref, extra = micro.width_loop, micro.width_loop_ref, (2, nd)
    else:
        K = args["NO"]
        lead = (args["batches"],) if args["batches"] > 1 else ()
        x, rhs = _i8(rng, lead + (args["rows"], K)), _i8(rng, lead + (K, K))
        kern, ref, extra = micro.mm_mask, micro.mm_mask_ref, (63, 2)
    x, rhs = _t(x).cuda(), _t(rhs).cuda()
    got = kern(x, rhs, *extra)
    torch.cuda.synchronize()
    want = ref(x, rhs, *extra)
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    assert all(torch.equal(g, w) for g, w in pairs)
