"""The port's error-rate tool (iyokan_tpu_torch/tools/measure_error_rate.py)
against the JAX package's (tools/measure_error_rate.py) at toy parameters.

Both tools run at ER_PARAMS=toy, ER_G=64, ER_BATCHES=2, ER_CASCADE=2 on
the same route, each writing its record to a file of its own; the records
agree exactly on the gates counted, the wrong ones, the cascade's counts
and the phase sigma (the same keys, inputs and ciphertexts: the two
packages are bit-identical).  A tool may exit 1 where toy noise exceeds
the cggi128 budget: the record is written before that.  Routes: the tkey
slab (the JAX side's Pallas kernel in interpret mode) and the exact NTT
route (the 2-bit-unrolled key at G=64: the JAX package's XLA product, the
port's extprod1 twin).
"""

import importlib.util
import json
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ER = {"ER_PARAMS": "toy", "ER_G": "64", "ER_BATCHES": "2",
      "ER_CASCADE": "2"}
ROUTES = {
    "tkey": {"IYOKAN_BR_IMPL": "tkey", "IYOKAN_PALLAS_INTERPRET": "1",
             "IYOKAN_SLAB_CACHE": "0"},
    "ntt": {"IYOKAN_BR_IMPL": "ntt"},
}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _record(main, path):
    try:
        main()
    except SystemExit as e:
        assert e.code == 1
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("route", list(ROUTES))
def test_error_rate_matches_jax_tool(route, tmp_path, monkeypatch):
    for k, v in {**ER, **ROUTES[route]}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("IYOKAN_TORCH_DEVICE", "cpu")

    from iyokan_tpu_torch.tools import measure_error_rate as port_tool

    monkeypatch.setenv("ER_OUT", str(tmp_path / "port.json"))
    got = _record(port_tool.main, tmp_path / "port.json")

    # the JAX tool reads ER_G and ER_BATCHES when it is loaded
    spec = importlib.util.spec_from_file_location(
        "jax_measure_error_rate",
        os.path.join(ROOT, "tools", "measure_error_rate.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    monkeypatch.setenv("ER_OUT", str(tmp_path / "jax.json"))
    want = _record(jax_tool.main, tmp_path / "jax.json")

    for key in ("params", "gates", "wrong", "cascade_gates", "cascade_wrong",
                "sigma", "margin_sigmas"):
        assert got[key] == want[key], key
    assert got["gates"] == 128 and got["cascade_gates"] == 128
    assert got["route"] == {"tkey": "tkey", "ntt": "ntt-unrolled"}[route]
    assert got["device"] == {"name": "cpu", "power_limit": None}
    assert got["env"]["IYOKAN_BR_IMPL"] == ROUTES[route]["IYOKAN_BR_IMPL"]


@pytest.mark.cuda
def test_error_rate_on_card_matches_cpu(tmp_path, monkeypatch):
    """The tool on the card (K1) gives the CPU twin's record."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels)")
    from iyokan_tpu_torch.tools import measure_error_rate as port_tool

    for k, v in {**ER, **ROUTES["tkey"]}.items():
        monkeypatch.setenv(k, v)
    recs = []
    for dev in ("cpu", "cuda"):
        monkeypatch.setenv("IYOKAN_TORCH_DEVICE", dev)
        monkeypatch.setenv("ER_OUT", str(tmp_path / f"{dev}.json"))
        recs.append(_record(port_tool.main, tmp_path / f"{dev}.json"))
    for key in ("gates", "wrong", "cascade_gates", "cascade_wrong", "sigma"):
        assert recs[0][key] == recs[1][key], key
    assert recs[1]["device"]["name"] == torch.cuda.get_device_name(0)
