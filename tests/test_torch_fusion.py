"""The port's execution modes against the JAX package, and its key caches.

* The level partition: the port's _group_plans(1 / 2 / 8 / 10**9 / None,
  the groups of IYOKAN_FUSE_LEVELS=all) equals the JAX engine's on mac16,
  memmac and tiny-ram.
* Under IYOKAN_FUSE_LEVELS = 1, 2, 3 (which divides no circuit's levels),
  8 and all the port's Frontend gives the ciphertexts and RAM stores of the
  JAX Frontend at IYOKAN_FUSE_LEVELS=1 (tkey slab, Pallas in interpret
  mode): MAC-4 x 3 cycles, tiny-ram x 3 cycles at refresh period 2 (a
  write, then a read of it, under both refresh flags) and tiny-rom x 1.
  On the CPU every mode's group, memory level and RAM write functions run
  eagerly on the static buffers; the sweep's one loop and those buffers
  are what these cases hold to the reference.  A timer and a progress
  callback run groups of one level: one time CSV row a level, progress
  counts summing to the circuit's gates, the same packet.
* The Frontend: the execution-mode log line equals JAX's (every knob
  combination; under all the port's own line); a snapshot taken at the
  default mode, or at FUSE=1 and resumed at 8, resumes to the straight
  run's bits.
* On the card (cuda-marked): each mode's CUDA graph replays equal the
  card's level-by-level run; at FUSE = 8 and 2 every graph (level groups,
  memory levels, the RAM write of each refresh flag) is captured at its
  second use and replayed from then on, with no eager launch after it;
  the RAM write's selectors survive gate groups captured before the
  memory level and replayed between it and the write; and a capture that
  fails raises, naming the graph, with no eager fallback.
* The device-key caches: a disk hit equals the rebuilt slab byte for byte
  (fat, fat2, the unrolled slab), a changed knob misses, IYOKAN_SLAB_CACHE=0
  writes nothing, a truncated file is rebuilt, and the in-process LRU
  returns the same DeviceKeys and evicts after IYOKAN_KEY_CACHE_SLOTS.
"""

import contextlib
import logging
import os
import sys

import numpy as np
import pytest
import torch

from iyokan_tpu import packet as jpacket
from iyokan_tpu.circuit.blueprint import Blueprint as JBlueprint
from iyokan_tpu.engine.driver import Frontend as JFrontend
from iyokan_tpu_torch.circuit.blueprint import Blueprint as TBlueprint
from iyokan_tpu_torch.crypto import ops as tops
from iyokan_tpu_torch.crypto import polymul as tpm
from iyokan_tpu_torch.engine.driver import Frontend as TFrontend

DATA = os.path.join(os.path.dirname(__file__), "data")

# the JAX engine as the port's tests run it: tkey slab, Pallas in
# interpret mode, no slab file
JAX_ENV = {"IYOKAN_BR_IMPL": "tkey", "IYOKAN_PALLAS_INTERPRET": "1",
           "IYOKAN_SLAB_CACHE": "0"}
MODES = ["1", "2", "3", "8", "all"]
MODE_IDS = ["fuse1", "fuse2", "fuse3", "fuse8", "all"]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def _env(**kw):
    """Knobs set (None: unset) for a block, restored after."""
    saved = {k: os.environ.get(k) for k in kw}

    def put(values):
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    put(kw)
    try:
        yield
    finally:
        put(saved)


def _mode_env(fuse):
    return {"IYOKAN_FUSE_LEVELS": fuse}


# --------------------------------------------------------------------------- #
# the circuits and their requests
# --------------------------------------------------------------------------- #


def _mac4_request():
    rng = np.random.default_rng(61)
    return jpacket.PlainPacket(bits={
        "a": rng.integers(0, 2, 12).astype(np.uint8),
        "b": rng.integers(0, 2, 12).astype(np.uint8)})


def _tiny_ram_request():
    """Cycle 0 writes 0b1011 to address 2, cycle 1 writes 0b0110 to
    address 1, cycle 2 reads address 1 back: at refresh period 2 cycles 1
    and 2 take the refresh flags on and off."""
    init = np.zeros(16, np.uint8)
    init[12:16] = 1
    return jpacket.PlainPacket(ram={"ramA": init}, bits={
        "addr": np.array([0, 1, 1, 0, 1, 0], np.uint8),
        "wren": np.array([1, 1, 0], np.uint8),
        "wdata": np.array([1, 1, 0, 1, 0, 1, 1, 0, 0, 0, 0, 0], np.uint8)})


def _tiny_rom_request():
    rom = np.random.default_rng(3).integers(0, 2, 64, dtype=np.uint8)
    return jpacket.PlainPacket(rom={"rom": rom},
                               bits={"addr": np.array([1, 0, 1], np.uint8)})


# name -> (blueprint, request, cycles, extra knobs)
CASES = {
    "mac4": ("mac4.toml", _mac4_request, 3, {}),
    "tiny-ram": ("tiny-ram.toml", _tiny_ram_request, 3,
                 {"IYOKAN_RAM_REFRESH_PERIOD": "2"}),
    "tiny-rom": ("tiny-rom.toml", _tiny_rom_request, 1, {}),
}
_JAX_REFS = {}


def _encrypted(name, sk):
    return CASES[name][1]().encrypt(sk, seed=7)


def _jax_reference(name, sk, ek):
    """The JAX Frontend's result packet at IYOKAN_FUSE_LEVELS=1 (computed
    once per module)."""
    if name not in _JAX_REFS:
        bp, _, cycles, extra = CASES[name]
        with _env(**JAX_ENV, **extra, IYOKAN_FUSE_LEVELS="1"):
            fe = JFrontend("tfhe", JBlueprint(os.path.join(DATA, bp)),
                           _encrypted(name, sk), eval_key=ek)
            fe.go(cycles)
            _JAX_REFS[name] = fe.make_result_packet()
    return _JAX_REFS[name]


def _port_run(name, sk, ek, fuse, device="cpu"):
    bp, _, cycles, extra = CASES[name]
    with _env(**JAX_ENV, **extra, **_mode_env(fuse)):
        fe = TFrontend("tfhe", TBlueprint(os.path.join(DATA, bp)),
                       _encrypted(name, sk), eval_key=ek, device=device)
        fe.go(cycles)
        return fe, fe.make_result_packet()


def _assert_same_packet(got, want):
    assert sorted(got.bits) == sorted(want.bits)
    assert sorted(got.ram) == sorted(want.ram)
    for name in want.bits:
        np.testing.assert_array_equal(got.bits[name], want.bits[name])
    for name in want.ram:
        np.testing.assert_array_equal(got.ram[name], want.ram[name])


# --------------------------------------------------------------------------- #
# the level partition
# --------------------------------------------------------------------------- #

_ENGINES = {}


def _engines(bp_name, ek):
    """(JAX engine, port engine) of a blueprint, built once."""
    if bp_name not in _ENGINES:
        from iyokan_tpu.circuit import compile as jcompile
        from iyokan_tpu.engine import driver as jdriver
        from iyokan_tpu.engine.tfhe import TFHEEngine as JEngine
        from iyokan_tpu_torch.circuit import compile as tcompile
        from iyokan_tpu_torch.engine import driver as tdriver
        from iyokan_tpu_torch.engine.tfhe import TFHEEngine as TEngine

        path = os.path.join(DATA, bp_name)
        with _env(**JAX_ENV):
            jeng = JEngine(jcompile.compile_design(
                jdriver.build_design(JBlueprint(path))), ek)
            teng = TEngine(tcompile.compile_design(
                tdriver.build_design(TBlueprint(path))), ek, "cpu")
        _ENGINES[bp_name] = (jeng, teng)
    return _ENGINES[bp_name]


def _jax_partition(jeng, max_group):
    """JAX's entries as (kind, levels in the group, gates, output nodes) or
    (kind, ROM reads, RAM reads)."""
    jeng._groups = None          # the JAX engine caches one partition
    dump = jeng.c.num_nodes
    out = []
    for entry in jeng._group_plans(max_group):
        if entry[0] == "mem":
            out.append(("mem", tuple(entry[1].rom_reads),
                        tuple(entry[1].ram_reads)))
            continue
        _, sig, flat, n = entry
        nodes, i = [], 0
        for (nb, nm, nnot, ncopy) in sig:
            if nb or nm:
                nodes += list(flat[i + 5]) + list(flat[i + 9])
                i += 10
            if nnot or ncopy:
                nodes += list(flat[i + 1]) + list(flat[i + 3])
                i += 4
        out.append(("group", len(sig), n,
                    tuple(sorted(int(v) for v in nodes if v != dump))))
    return out


def _port_partition(teng, max_group):
    out = []
    for entry in teng._group_plans(max_group):
        if entry[0] == "mem":
            plan = teng.c.levels[entry[1]]
            out.append(("mem", tuple(plan.rom_reads), tuple(plan.ram_reads)))
            continue
        _, levels, n = entry
        nodes = []
        for lv in levels:
            plan = teng.c.levels[lv]
            nodes += [*plan.bin_out, *plan.mux_out, *plan.not_out,
                      *plan.copy_out]
        out.append(("group", len(levels), n,
                    tuple(sorted(int(v) for v in nodes))))
    return out


@pytest.mark.parametrize("max_group", [1, 2, 8, 10**9, "all"])
@pytest.mark.parametrize("bp_name", ["mac16.toml", "memmac.toml",
                                     "tiny-ram.toml"])
def test_group_plans_match_jax(toy_ek, bp_name, max_group):
    """"all": the port's groups of no size limit (_group_plans(None)), the
    JAX engine's of 10**9 levels."""
    jeng, teng = _engines(bp_name, toy_ek)
    want = _jax_partition(jeng, 10**9 if max_group == "all" else max_group)
    got = _port_partition(teng, None if max_group == "all" else max_group)
    assert got == want
    assert any(e[0] == "group" for e in got)
    if bp_name != "mac16.toml":
        assert any(e[0] == "mem" for e in got)


# --------------------------------------------------------------------------- #
# the modes against the JAX Frontend at FUSE=1
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("fuse", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("name", list(CASES))
def test_modes_match_jax(toy_sk, toy_ek, name, fuse):
    want = _jax_reference(name, toy_sk, toy_ek)
    _, got = _port_run(name, toy_sk, toy_ek, fuse)
    _assert_same_packet(got, want)
    if name == "tiny-ram":
        dec = got.decrypt(toy_sk)
        np.testing.assert_array_equal(dec.bits["rdata"], [0, 1, 1, 0])
        np.testing.assert_array_equal(dec.ram["ramA"][4:12],
                                      [0, 1, 1, 0, 1, 1, 0, 1])


@pytest.mark.parametrize("name", list(CASES))
def test_timer_and_progress_run_level_by_level(toy_sk, toy_ek, tmp_path,
                                               monkeypatch, name):
    """--dump-time-csv-prefix and --show-combinational-progress at the
    default mode run the sweep in groups of one level: the packet == the
    JAX Frontend's at FUSE=1, each cycle's timer holds one entry a level
    (the time CSV one row of seconds a level), and its progress counts sum
    to the circuit's gates; the circuit-graph dumps name every cycle."""
    from iyokan_tpu_torch.engine import tfhe

    real = tfhe.TFHEEngine.settle
    seen = []                            # (timer, progress counts) a cycle

    def settle(self, vals, rams, roms, timer=None, progress=None, **kw):
        if timer is None:                # the reset settle
            return real(self, vals, rams, roms, **kw)
        counts = []
        out = real(self, vals, rams, roms, timer=timer,
                   progress=lambda n: (counts.append(n), progress(n)), **kw)
        seen.append((timer, counts))
        return out

    monkeypatch.setattr(tfhe.TFHEEngine, "settle", settle)
    bp, _, cycles, extra = CASES[name]
    want = _jax_reference(name, toy_sk, toy_ek)
    with _env(**JAX_ENV, **extra, **_mode_env(None)):
        fe = TFrontend("tfhe", TBlueprint(os.path.join(DATA, bp)),
                       _encrypted(name, toy_sk), eval_key=toy_ek,
                       device="cpu")
        fe.go(cycles, dump_time_csv_prefix=str(tmp_path / "t"),
              show_combinational_progress=True,
              dump_graph_json_prefix=str(tmp_path / "g"),
              dump_graph_dot_prefix=str(tmp_path / "d"))
    _assert_same_packet(fe.make_result_packet(), want)
    levels = fe.compiled.levels
    gate_levels = [p for p in levels if p.n_gates]
    assert len(seen) == cycles
    for c, (timer, counts) in enumerate(seen):
        assert len(timer) == len(levels) and min(timer) >= 0
        assert counts == [p.n_gates for p in gate_levels]
        assert sum(counts) == sum(p.n_gates for p in levels)
        with open(tmp_path / f"t-{c}.csv") as f:
            rows = [ln.rstrip("\n").split(",") for ln in f][1:]
        assert [r[1] for r in rows] == [
            str(lv + 1) for lv in range(len(levels))] + ["total"]
        assert all(float(r[3]) >= 0 for r in rows)
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"{k}-{c}.{ext}" for c in range(cycles)
        for k, ext in (("d", "dot"), ("g", "json"), ("t", "csv")))


# --------------------------------------------------------------------------- #
# the Frontend: the mode's log line, snapshots
# --------------------------------------------------------------------------- #


def _frontends(sk, ek, mode="tfhe", bp_name="mac4.toml"):
    path = os.path.join(DATA, bp_name)
    req = _mac4_request()
    if mode == "tfhe":
        req = req.encrypt(sk, seed=7)
        kw = {"eval_key": ek}
    else:
        kw = {}
    with _env(**JAX_ENV):
        jfe = JFrontend(mode, JBlueprint(path), req, **kw)
        tfe = TFrontend(mode, TBlueprint(path), req, device="cpu", **kw)
    return jfe, tfe


# (knobs, go() keywords): every branch of _log_execution_mode
LOG_CASES = {
    "default": ({}, {}),
    "fuse1": ({"IYOKAN_FUSE_LEVELS": "1"}, {}),
    "fuse3": ({"IYOKAN_FUSE_LEVELS": "3"}, {}),
    "all": ({"IYOKAN_FUSE_LEVELS": "all"}, {}),
    "dump": ({"IYOKAN_FUSE_LEVELS": "all"}, {"dump_prefix": "unused"}),
    "profile-csv": ({"IYOKAN_FUSE_LEVELS": "all", "IYOKAN_PROFILE": "1"},
                    {"stdout_csv": True}),
    "observers": ({"IYOKAN_FUSE_LEVELS": "all"},
                  {"dump_time_csv_prefix": "unused",
                   "show_combinational_progress": True,
                   "on_cycle": lambda fe: None}),
    "plain": ({"IYOKAN_FUSE_LEVELS": "all"}, {}),
}
# the port's own line under IYOKAN_FUSE_LEVELS=all, whatever observes the
# cycles: groups of any size (the JAX package's whole-cycle path and its
# scan are not the port's)
ALL_LINE = ("execution mode: per-level dispatch, gate levels fused in "
            "groups of any size (IYOKAN_FUSE_LEVELS=all)")


def _mode_lines(fe, knobs, kw, caplog):
    caplog.clear()
    with _env(**{"IYOKAN_FUSE_LEVELS": None, "IYOKAN_PROFILE": None,
                 **knobs}):
        with caplog.at_level(logging.INFO, logger="iyokan"):
            fe.go(0, skip_reset=True, **kw)
    return [r.getMessage() for r in caplog.records
            if r.getMessage().startswith(("execution mode", "invalid"))]


@pytest.mark.parametrize("case", list(LOG_CASES))
def test_execution_mode_log_matches_jax(toy_sk, toy_ek, caplog, case):
    knobs, kw = LOG_CASES[case]
    jfe, tfe = _frontends(toy_sk, toy_ek,
                          mode="plain" if case == "plain" else "tfhe")
    got = _mode_lines(tfe, knobs, kw, caplog)
    if knobs.get("IYOKAN_FUSE_LEVELS") == "all" and case != "plain":
        assert got == [ALL_LINE]
    else:
        assert got == _mode_lines(jfe, knobs, kw, caplog)
        assert len(got) == 1


def _snapshot_resumes_bit_identical(sk, ek, fuse, first_fuse=None):
    """tiny-ram at refresh period 2: 4 straight cycles == 2 cycles, a
    snapshot, and 2 resumed cycles; the straight and resumed runs in the
    mode `fuse`, the snapshotted one in `first_fuse` (default: the same)."""
    path = os.path.join(DATA, "tiny-ram.toml")
    init = np.zeros(16, np.uint8)
    init[4:8] = 1
    req = jpacket.PlainPacket(ram={"ramA": init}, bits={
        "addr": np.array([0, 1, 1, 0, 1, 0, 0, 1], np.uint8),
        "wren": np.array([1, 0, 1, 0], np.uint8),
        "wdata": np.array([1, 0, 1, 1] * 4, np.uint8)}).encrypt(sk, seed=5)
    with _env(**JAX_ENV, IYOKAN_RAM_REFRESH_PERIOD="2"):
        with _env(**_mode_env(fuse)):
            straight = TFrontend("tfhe", TBlueprint(path), req, eval_key=ek,
                                 device="cpu")
            straight.go(4)
        with _env(**_mode_env(first_fuse or fuse)):
            first = TFrontend("tfhe", TBlueprint(path), req, eval_key=ek,
                              device="cpu")
            first.go(2)
        with _env(**_mode_env(fuse)):
            resumed = TFrontend("tfhe", TBlueprint(path), req, eval_key=ek,
                                snapshot_state=first.snapshot_state(),
                                device="cpu")
            resumed.go(2)
    _assert_same_packet(resumed.make_result_packet(),
                        straight.make_result_packet())
    np.testing.assert_array_equal(
        resumed.snapshot_state()["vals"], straight.snapshot_state()["vals"])
    return straight, resumed


def test_snapshot_at_the_default_mode_resumes_bit_identical(toy_sk, toy_ek):
    """At the default IYOKAN_FUSE_LEVELS (8), where the memory level and
    the RAM write run on the engine's static buffers: the snapshot's RAM
    stores are those buffers, and the resumed run adopts them anew."""
    straight, resumed = _snapshot_resumes_bit_identical(toy_sk, toy_ek,
                                                        None)
    for fe in (straight, resumed):
        assert fe.rams["ramA"] is fe.engine._ram_bufs["ramA"]


def test_snapshot_at_fuse1_resumes_at_fuse8_bit_identical(toy_sk, toy_ek):
    """A snapshot taken level by level (FUSE=1) resumes in groups of 8 to
    the bits of a straight run in groups of 8."""
    _snapshot_resumes_bit_identical(toy_sk, toy_ek, "8", first_fuse="1")


# --------------------------------------------------------------------------- #
# on the card: graph replays == the eager run; no eager fallback
# --------------------------------------------------------------------------- #


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs, CUDA kernels)")


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", ["2", "8", "all"],
                         ids=["fuse2", "fuse8", "all"])
@pytest.mark.parametrize("name", ["mac4", "tiny-ram"])
def test_graph_replays_equal_eager_on_card(toy_sk, toy_ek, name, fuse):
    _card()
    _, want = _port_run(name, toy_sk, toy_ek, "1", device="cuda")
    fe, got = _port_run(name, toy_sk, toy_ek, fuse, device="cuda")
    _assert_same_packet(got, want)
    stats = fe.engine.graph_stats()
    assert stats and all(g["replays"] > 0 for g in stats)
    assert all(g["name"].startswith(("level group", "memory level",
                                     "RAM write")) for g in stats)
    # tiny-ram's levels only copy: its launches are its memory graphs'
    assert sum(fe.engine.graph_launches().values()) > 0


def _memmac_request():
    sys.path.insert(0, DATA)
    import gen_mac

    rom, rams, streams = gen_mac.memmac_request(4, 0)
    return jpacket.PlainPacket(rom={"rom": rom}, ram=rams, bits=streams)


# name -> (blueprint, request, knobs, cycles of each go(), the go() after
# which no kernel launches eagerly)
MEMORY_GRAPH_RUNS = {
    "tiny-ram": ("tiny-ram.toml", _tiny_ram_request,
                 {"IYOKAN_RAM_REFRESH_PERIOD": "2"}, (2, 1, 3), 1),
    "memmac": ("memmac.toml", _memmac_request,
               {"IYOKAN_RAM_REFRESH_PERIOD": None}, (1, 1, 2), 0),
}


def _expected_memory_graphs(engine, settles):
    """{graph name: replays} of the memory levels' and RAM writes' graphs
    after the settles [refresh flag, ...]: a graph used k >= 2 times was
    captured at its second use and replayed k - 1 times; one used once was
    not captured."""
    from iyokan_tpu_torch.engine.tfhe import graph_name

    uses = {("mem", lv): len(settles)
            for lv, m in enumerate(engine._mems) if m is not None}
    for flag in settles:
        key = ("ram_write", flag)
        uses[key] = uses.get(key, 0) + 1
    return {graph_name(k): n - 1 for k, n in uses.items() if n > 1}


@pytest.mark.cuda
@pytest.mark.parametrize("name,fuse", [("tiny-ram", "8"), ("tiny-ram", "2"),
                                       ("memmac", "8")])
def test_memory_graphs_replay_on_card(toy_sk, toy_ek, name, fuse):
    """At FUSE = N > 1 the memory levels and the RAM write of each refresh
    flag replay CUDA graphs captured at their second use: the packet ==
    FUSE=1's byte for byte (tiny-ram: both flags over three refresh
    periods of 2; memmac: its @reset settle, whose full refresh write is
    used once), each graph's replays == its uses - 1 after every go(), a
    graph used once never captured, the gate groups replayed from the
    second settle on, and no eager launch once every graph in use has been
    captured."""
    _card()
    from iyokan_tpu_torch.engine import tfhe

    tfhe.clear_engine_cache()     # the counts are a fresh engine's
    bp, make_req, knobs, stops, frozen_from = MEMORY_GRAPH_RUNS[name]
    path = os.path.join(DATA, bp)
    req = make_req().encrypt(toy_sk, seed=7)
    with _env(**JAX_ENV, **knobs, **_mode_env("1")):
        ref = TFrontend("tfhe", TBlueprint(path), req, eval_key=toy_ek,
                        device="cuda")
        ref.go(sum(stops))
        want = ref.make_result_packet()
    period = int(knobs["IYOKAN_RAM_REFRESH_PERIOD"] or 16)
    settles = [True] if TBlueprint(path).at("reset") is not None else []
    counts = []
    with _env(**JAX_ENV, **knobs, **_mode_env(fuse)):
        fe = TFrontend("tfhe", TBlueprint(path), req, eval_key=toy_ek,
                       device="cuda")
        for n in stops:
            c0 = fe.current_cycle
            fe.go(n)
            settles += [(c + 1) % period == 0 for c in range(c0, c0 + n)]
            stats = fe.engine.graph_stats()
            got = {g["name"]: g["replays"] for g in stats
                   if not g["name"].startswith("level group")}
            assert got == _expected_memory_graphs(fe.engine, settles)
            groups = [g["replays"] for g in stats
                      if g["name"].startswith("level group")]
            assert groups and all(r == len(settles) - 1 for r in groups)
            counts.append(tfhe.launch_counts())
        got_packet = fe.make_result_packet()
    _assert_same_packet(got_packet, want)
    assert {True, False} <= set(settles)
    assert all(c == counts[frozen_from] for c in counts[frozen_from:])


@pytest.mark.cuda
def test_ram_selectors_survive_groups_captured_before_them_on_card(
        toy_sk, toy_ek, monkeypatch):
    """memmac at FUSE=8, refresh period 2: its gate groups, which run
    between the memory level and the RAM write, are captured before the
    memory level (right after the reset settle), and each fills and drops
    a scratch tensor of the circuit bootstrapping's output size.  Their
    freed blocks are what the memory level's capture in the shared pool
    would be handed for its selectors, and their replays would overwrite
    them before the RAM write read them; the selectors are static buffers
    made at the first use, so the packet == FUSE=1's byte for byte."""
    _card()
    from iyokan_tpu_torch.engine import tfhe

    tfhe.clear_engine_cache()     # its graphs are captured in this test
    path = os.path.join(DATA, "memmac.toml")
    req = _memmac_request().encrypt(toy_sk, seed=7)
    knobs = {"IYOKAN_RAM_REFRESH_PERIOD": "2"}
    with _env(**JAX_ENV, **knobs, **_mode_env("1")):
        ref = TFrontend("tfhe", TBlueprint(path), req, eval_key=toy_ek,
                        device="cuda")
        ref.go(4)
        want = ref.make_result_packet()

    eng_cls = tfhe.TFHEEngine
    real_cb, real_gates = eng_cls._cb_pairs, eng_cls._gate_levels
    real_settle = eng_cls.settle
    seen = {}

    def cb_pairs(self, *a):
        out = real_cb(self, *a)
        seen.setdefault("cb", (out.shape, out.dtype))
        return out

    def gate_levels(self, levels):
        real_gates(self, levels)
        shape, dtype = seen["cb"]
        torch.full(shape, -1, dtype=dtype, device=self.device)

    def settle(self, *a, **kw):
        out = real_settle(self, *a, **kw)
        if "sel" not in seen:
            seen["sel"] = {n: t.data_ptr() for n, t in self._sel_bufs.items()}
            plan = self._group_plans(8)
            assert plan[0][0] == "mem" and len(plan) > 1
            for i, entry in enumerate(plan):
                if entry[0] == "group":   # its second use: captured
                    self._run(("group", 8, i, entry[1]),
                              lambda lvs=entry[1]: self._gate_levels(lvs))
        return out

    monkeypatch.setattr(eng_cls, "_cb_pairs", cb_pairs)
    monkeypatch.setattr(eng_cls, "_gate_levels", gate_levels)
    monkeypatch.setattr(eng_cls, "settle", settle)
    with _env(**JAX_ENV, **knobs, **_mode_env("8")):
        fe = TFrontend("tfhe", TBlueprint(path), req, eval_key=toy_ek,
                       device="cuda")
        fe.go(4)
        got = fe.make_result_packet()
    names = [g["name"] for g in fe.engine.graph_stats()]
    first_mem = names.index("memory level 0")
    assert first_mem > 0 and all(n.startswith("level group")
                                 for n in names[:first_mem])
    assert {"RAM write (refresh=True)", "RAM write (refresh=False)"} <= set(
        names)
    assert seen["sel"] and seen["sel"] == {
        n: t.data_ptr() for n, t in fe.engine._sel_bufs.items()}
    _assert_same_packet(got, want)


@pytest.mark.cuda
def test_failed_capture_raises_without_eager_fallback(toy_sk, toy_ek,
                                                      monkeypatch):
    """A host read inside a group (a sync, refused under capture) makes
    the capture raise, naming the group; the run does not go on eagerly."""
    _card()
    from iyokan_tpu_torch.engine import tfhe

    tfhe.clear_engine_cache()     # a kept engine would replay, not capture
    real = tfhe.TFHEEngine._gate_levels

    def syncing(self, levels):
        real(self, levels)
        self._vals[0, 0].item()

    monkeypatch.setattr(tfhe.TFHEEngine, "_gate_levels", syncing)
    with pytest.raises(RuntimeError, match="CUDA graph capture of level "
                                           "group"):
        _port_run("mac4", toy_sk, toy_ek, "8", device="cuda")


# --------------------------------------------------------------------------- #
# the device-key caches
# --------------------------------------------------------------------------- #


@pytest.fixture()
def slab_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("IYOKAN_BR_IMPL", "tkey")
    monkeypatch.setenv("IYOKAN_SLAB_CACHE", str(tmp_path))
    for k in ("IYOKAN_TK_LAYOUT", "IYOKAN_TK_UNROLL", "IYOKAN_TK_LB",
              "IYOKAN_TKEY_LIMBS", "IYOKAN_TK_SMALL",
              "IYOKAN_KEY_CACHE_SLOTS"):
        monkeypatch.delenv(k, raising=False)
    tops.clear_device_key_cache()
    yield tmp_path
    tops.clear_device_key_cache()


def _keys(ek):
    return tops.DeviceKeys.from_evalkey(ek, "cpu", with_cb=False)


def _slab_files(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".npy"))


@pytest.mark.parametrize("knobs", [{}, {"IYOKAN_TK_LAYOUT": "fat2"},
                                   {"IYOKAN_TK_UNROLL": "1"}],
                         ids=["fat", "fat2", "unrolled"])
def test_slab_disk_hit_equals_rebuild(toy_ek, slab_dir, monkeypatch, knobs):
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    built = _keys(toy_ek).bk_tk
    assert len(_slab_files(slab_dir)) == 1
    tops.clear_device_key_cache()

    def no_build(*a, **kw):
        raise AssertionError("the slab was rebuilt, not read")

    real = tpm.tkey_kernel_key
    monkeypatch.setattr(tpm, "tkey_kernel_key", no_build)
    read = _keys(toy_ek).bk_tk
    monkeypatch.setattr(tpm, "tkey_kernel_key", real)
    assert read.stride() == built.stride()
    assert read.numpy().tobytes() == built.numpy().tobytes()
    L, lay, lb = tops.tkey_default_config(toy_ek.params)
    src = toy_ek.bk if not knobs.get("IYOKAN_TK_UNROLL") else \
        toy_ek.bku.reshape(toy_ek.bku.shape[0], 6 * toy_ek.params.l, 2,
                           toy_ek.params.N)
    want = tpm.tkey_kernel_key(src, toy_ek.params, L, lay, lb=lb)
    np.testing.assert_array_equal(read.numpy(), want)


@pytest.mark.parametrize("knob,value", [("IYOKAN_TK_LB", "1"),
                                        ("IYOKAN_TKEY_LIMBS", "4")])
def test_changed_knob_misses_the_disk_cache(toy_ek, slab_dir, monkeypatch,
                                            knob, value):
    first = _keys(toy_ek).bk_tk
    monkeypatch.setenv(knob, value)
    other = _keys(toy_ek).bk_tk
    assert len(_slab_files(slab_dir)) == 2
    assert first.shape != other.shape or not torch.equal(first, other)


def test_slab_cache_off_writes_nothing(toy_ek, slab_dir, tmp_path,
                                       monkeypatch):
    d = tmp_path / "keys"
    monkeypatch.setenv("IYOKAN_KEY_CACHE", str(d))
    monkeypatch.setenv("IYOKAN_SLAB_CACHE", "0")
    _keys(toy_ek)
    assert not d.exists() and not _slab_files(slab_dir)
    # unset: the IYOKAN_KEY_CACHE directory
    monkeypatch.delenv("IYOKAN_SLAB_CACHE")
    tops.clear_device_key_cache()
    _keys(toy_ek)
    assert len(_slab_files(d)) == 1


def test_truncated_slab_file_is_rebuilt(toy_ek, slab_dir):
    built = _keys(toy_ek).bk_tk.numpy().copy()
    (f,) = _slab_files(slab_dir)
    path = slab_dir / f
    size = path.stat().st_size
    with open(path, "r+b") as fh:
        fh.truncate(size // 2)
    tops.clear_device_key_cache()
    again = _keys(toy_ek).bk_tk.numpy()
    assert again.tobytes() == built.tobytes()
    assert path.stat().st_size == size            # written anew


def test_key_cache_lru(toy_ek, slab_dir, monkeypatch):
    """The same key and knobs give the same DeviceKeys; three knob sets
    through two slots evict the oldest."""
    monkeypatch.setenv("IYOKAN_KEY_CACHE_SLOTS", "2")
    a = _keys(toy_ek)
    assert _keys(toy_ek) is a
    monkeypatch.setenv("IYOKAN_TK_LB", "1")
    b = _keys(toy_ek)
    assert b is not a and _keys(toy_ek) is b
    monkeypatch.setenv("IYOKAN_TK_LB", "3")
    c = _keys(toy_ek)
    assert _keys(toy_ek) is c
    monkeypatch.setenv("IYOKAN_TK_LB", "1")
    assert _keys(toy_ek) is b                     # still held
    monkeypatch.delenv("IYOKAN_TK_LB")
    assert _keys(toy_ek) is not a                 # evicted
