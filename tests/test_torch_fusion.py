"""The port's execution modes against the JAX package, and its key caches.

* The level partition: the port's _group_plans(1 / 2 / 8 / 10**9) equals
  the JAX engine's on mac16, memmac and tiny-ram.
* Under IYOKAN_FUSE_LEVELS = 2, 8 and all (scan chunk 2 and max) the
  port's Frontend gives the ciphertexts and RAM stores of the JAX Frontend
  at IYOKAN_FUSE_LEVELS=1 (tkey slab, Pallas in interpret mode): MAC-4 x 3
  cycles, tiny-ram x 3 cycles at refresh period 2 (a write, then a read of
  it inside the scanned span of mixed refresh flags) and tiny-rom x 1.
  On the CPU the modes' group, cycle and span functions run eagerly; the
  Frontend's span logic, the static buffers and the scan's input staging are
  what these cases hold to the reference.
* The Frontend: _circular_input_rows and the execution-mode log line equal
  JAX's (every knob combination, the "disabled by" cases and an invalid
  IYOKAN_SCAN_CHUNK); a snapshot taken inside a scanned run resumes to
  the straight run's bits.
* On the card (cuda-marked): each mode's CUDA graph replays equal the
  card's level-by-level run, and a capture that fails raises, naming the
  graph, with no eager fallback.
* The device-key caches: a disk hit equals the rebuilt slab byte for byte
  (fat, fat2, the unrolled slab), a changed knob misses, IYOKAN_SLAB_CACHE=0
  writes nothing, a truncated file is rebuilt, and the in-process LRU
  returns the same DeviceKeys and evicts after IYOKAN_KEY_CACHE_SLOTS.
"""

import contextlib
import logging
import os

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
MODES = [("2", None), ("8", None), ("all", "2"), ("all", "max")]
MODE_IDS = ["fuse2", "fuse8", "all-chunk2", "all-chunkmax"]


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


def _mode_env(fuse, chunk):
    return {"IYOKAN_FUSE_LEVELS": fuse, "IYOKAN_SCAN_CHUNK": chunk}


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
    and 2 are one span of flags [on, off]."""
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


def _port_run(name, sk, ek, fuse, chunk, device="cpu"):
    bp, _, cycles, extra = CASES[name]
    with _env(**JAX_ENV, **extra, **_mode_env(fuse, chunk)):
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


@pytest.mark.parametrize("max_group", [1, 2, 8, 10**9])
@pytest.mark.parametrize("bp_name", ["mac16.toml", "memmac.toml",
                                     "tiny-ram.toml"])
def test_group_plans_match_jax(toy_ek, bp_name, max_group):
    jeng, teng = _engines(bp_name, toy_ek)
    want = _jax_partition(jeng, max_group)
    got = _port_partition(teng, max_group)
    assert got == want
    assert any(e[0] == "group" for e in got)
    if bp_name != "mac16.toml":
        assert any(e[0] == "mem" for e in got)


# --------------------------------------------------------------------------- #
# the modes against the JAX Frontend at FUSE=1
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("fuse,chunk", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("name", list(CASES))
def test_modes_match_jax(toy_sk, toy_ek, name, fuse, chunk):
    want = _jax_reference(name, toy_sk, toy_ek)
    _, got = _port_run(name, toy_sk, toy_ek, fuse, chunk)
    _assert_same_packet(got, want)
    if name == "tiny-ram":
        dec = got.decrypt(toy_sk)
        np.testing.assert_array_equal(dec.bits["rdata"], [0, 1, 1, 0])
        np.testing.assert_array_equal(dec.ram["ramA"][4:12],
                                      [0, 1, 1, 0, 1, 1, 0, 1])


# --------------------------------------------------------------------------- #
# the Frontend: input rows, the mode's log line, snapshot inside a scan
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


@pytest.mark.parametrize("start,k", [(0, 3), (1, 2), (5, 4)])
def test_circular_input_rows_match_jax(toy_sk, toy_ek, start, k):
    jfe, tfe = _frontends(toy_sk, toy_ek)
    jn, jr = jfe._circular_input_rows(start, k)
    tn, tr = tfe._circular_input_rows(start, k)
    assert list(tn) == list(jn)
    assert tr.dtype == jr.dtype == np.uint32
    np.testing.assert_array_equal(tr, jr)


# (knobs, go() keywords): every branch of _log_execution_mode
LOG_CASES = {
    "default": ({}, {}),
    "fuse1": ({"IYOKAN_FUSE_LEVELS": "1"}, {}),
    "fuse3": ({"IYOKAN_FUSE_LEVELS": "3"}, {}),
    "scan": ({"IYOKAN_FUSE_LEVELS": "all"}, {}),
    "scan-max": ({"IYOKAN_FUSE_LEVELS": "all", "IYOKAN_SCAN_CHUNK": "max"},
                 {}),
    "scan-chunk0": ({"IYOKAN_FUSE_LEVELS": "all", "IYOKAN_SCAN_CHUNK": "0"},
                    {}),
    "scan-chunk-junk": ({"IYOKAN_FUSE_LEVELS": "all",
                         "IYOKAN_SCAN_CHUNK": "x2"}, {}),
    "dump": ({"IYOKAN_FUSE_LEVELS": "all"}, {"dump_prefix": "unused"}),
    "profile-csv": ({"IYOKAN_FUSE_LEVELS": "all", "IYOKAN_PROFILE": "1"},
                    {"stdout_csv": True}),
    "observers": ({"IYOKAN_FUSE_LEVELS": "all"},
                  {"dump_time_csv_prefix": "unused",
                   "show_combinational_progress": True,
                   "on_cycle": lambda fe: None}),
    "plain": ({"IYOKAN_FUSE_LEVELS": "all"}, {}),
}


def _mode_lines(fe, knobs, kw, caplog):
    caplog.clear()
    with _env(**{"IYOKAN_FUSE_LEVELS": None, "IYOKAN_SCAN_CHUNK": None,
                 "IYOKAN_PROFILE": None, **knobs}):
        with caplog.at_level(logging.INFO, logger="iyokan"):
            fe.go(0, skip_reset=True, **kw)
    return [r.getMessage() for r in caplog.records
            if r.getMessage().startswith(("execution mode", "invalid"))]


@pytest.mark.parametrize("case", list(LOG_CASES))
def test_execution_mode_log_matches_jax(toy_sk, toy_ek, caplog, case):
    knobs, kw = LOG_CASES[case]
    jfe, tfe = _frontends(toy_sk, toy_ek,
                          mode="plain" if case == "plain" else "tfhe")
    want = _mode_lines(jfe, knobs, kw, caplog)
    got = _mode_lines(tfe, knobs, kw, caplog)
    assert got == want
    assert len(got) == (2 if "chunk" in case and case != "scan-max" else 1)


def test_snapshot_inside_a_scan_resumes_bit_identical(toy_sk, toy_ek):
    """tiny-ram under IYOKAN_FUSE_LEVELS=all, chunk 2, refresh period 2:
    4 straight cycles (cycle 0, the span 1-2, cycle 3) == 2 cycles (cycle
    0, cycle 1), a snapshot, and 2 resumed cycles (the span 2-3)."""
    path = os.path.join(DATA, "tiny-ram.toml")
    init = np.zeros(16, np.uint8)
    init[4:8] = 1
    req = jpacket.PlainPacket(ram={"ramA": init}, bits={
        "addr": np.array([0, 1, 1, 0, 1, 0, 0, 1], np.uint8),
        "wren": np.array([1, 0, 1, 0], np.uint8),
        "wdata": np.array([1, 0, 1, 1] * 4, np.uint8)}).encrypt(toy_sk,
                                                                 seed=5)
    with _env(**JAX_ENV, IYOKAN_RAM_REFRESH_PERIOD="2",
              **_mode_env("all", "2")):
        straight = TFrontend("tfhe", TBlueprint(path), req, eval_key=toy_ek,
                             device="cpu")
        straight.go(4)
        first = TFrontend("tfhe", TBlueprint(path), req, eval_key=toy_ek,
                          device="cpu")
        first.go(2)
        resumed = TFrontend("tfhe", TBlueprint(path), req, eval_key=toy_ek,
                            snapshot_state=first.snapshot_state(),
                            device="cpu")
        resumed.go(2)
    _assert_same_packet(resumed.make_result_packet(),
                        straight.make_result_packet())
    np.testing.assert_array_equal(
        resumed.snapshot_state()["vals"], straight.snapshot_state()["vals"])


def test_scanned_span_dumps_each_cycles_graph(toy_sk, toy_ek, tmp_path):
    """The circuit-graph dumps name every cycle of a scanned span, as the
    per-cycle path does."""
    with _env(**JAX_ENV, **_mode_env("all", "max")):
        fe = TFrontend("tfhe", TBlueprint(os.path.join(DATA, "mac4.toml")),
                       _encrypted("mac4", toy_sk), eval_key=toy_ek,
                       device="cpu")
        fe.go(3, dump_graph_json_prefix=str(tmp_path / "g"),
              dump_graph_dot_prefix=str(tmp_path / "d"))
    assert sorted(os.listdir(tmp_path)) == [
        "d-0.dot", "d-1.dot", "d-2.dot", "g-0.json", "g-1.json", "g-2.json"]


# --------------------------------------------------------------------------- #
# on the card: graph replays == the eager run; no eager fallback
# --------------------------------------------------------------------------- #


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs, CUDA kernels)")


@pytest.mark.cuda
@pytest.mark.parametrize("fuse,chunk", MODES[:3], ids=MODE_IDS[:3])
@pytest.mark.parametrize("name", ["mac4", "tiny-ram"])
def test_graph_replays_equal_eager_on_card(toy_sk, toy_ek, name, fuse,
                                           chunk):
    _card()
    _, want = _port_run(name, toy_sk, toy_ek, "1", None, device="cuda")
    fe, got = _port_run(name, toy_sk, toy_ek, fuse, chunk, device="cuda")
    _assert_same_packet(got, want)
    stats = fe.engine.graph_stats()
    assert stats and all(g["replays"] > 0 for g in stats)
    if name == "mac4" or fuse == "all":   # tiny-ram's levels only copy
        assert sum(fe.engine.graph_launches().values()) > 0


@pytest.mark.cuda
def test_failed_capture_raises_without_eager_fallback(toy_sk, toy_ek,
                                                      monkeypatch):
    """A host read inside a group (a sync, refused under capture) makes
    the capture raise, naming the group; the run does not go on eagerly."""
    _card()
    from iyokan_tpu_torch.engine import tfhe

    real = tfhe.TFHEEngine._gate_levels

    def syncing(self, levels):
        real(self, levels)
        self._vals[0, 0].item()

    monkeypatch.setattr(tfhe.TFHEEngine, "_gate_levels", syncing)
    with pytest.raises(RuntimeError, match="CUDA graph capture of level "
                                           "group"):
        _port_run("mac4", toy_sk, toy_ek, "8", None, device="cuda")


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
