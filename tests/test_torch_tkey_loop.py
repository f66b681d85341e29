"""K1's persistent small-batch form (csrc/tkey_loop.cuh, ops/tkey.py:
loop_plan, route_form).

On the CPU: the plan covers every (output block K, gate, contraction row,
column) product of a step exactly once, each with the digit source and
sign of the K-major product (tkey.k_tile_order), at NB = 2 and 8 on every
layout it serves; a torch execution of the plan (clusters of NB CTAs, each
CTA's partials over the stacked digit blocks, the wrap sign on the
partials, the cluster's reduction by the owner of each output block, the
accumulator ping-ponged between two buffers) equals the twin and the JAX
Pallas kernel (interpret mode) bit for bit; the route sends 16-gate
batches on fat and thin to the persistent form, and the unrolled slab and
fat2 (which it does not serve) to the per-step forms.  On the card
(cuda-marked): the kernel == the twin at Gp = 16-128 on each layout it
serves, eagerly and as a CUDA graph replayed twice (the grid barrier's
word is zeroed by a memset captured beside the launch).
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iyokan_tpu.crypto import host as jhost
from iyokan_tpu.ops import pallas_tk
from iyokan_tpu_torch import params as tparams
from iyokan_tpu_torch.crypto import ops as tops
from iyokan_tpu_torch.crypto.ops import MASK32
from iyokan_tpu_torch.crypto import polymul as tpm
from iyokan_tpu_torch.ops import tkey

P = tparams.TOY
# form -> (key source, limbs, layout, lb): the layouts the form serves
LOOP_FORMS = {
    "fat": ("bk", 3, "fat", 2),
    "thin": ("bk", 3, "thin", 2),
    "fat-L4-lb3": ("bk", 4, "fat", 3),
}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def slabs(toy_ek):
    """form -> its slab at toy parameters (built once per module)."""
    return {name: tpm.tkey_kernel_key(toy_ek.bk, P, limbs, layout, lb=lb)
            for name, (_, limbs, layout, lb) in LOOP_FORMS.items()}


def _random_slab(form, p, n, rng):
    """A random K-contiguous slab of `form` at p with n key steps."""
    _, limbs, layout, lb = LOOP_FORMS[form]
    keyrows = rng.integers(0, 1 << 32, (n, 2 * p.l, 2, p.N), dtype=np.uint32)
    return tkey.k_contiguous(tpm.tkey_kernel_key(keyrows, p, limbs, layout,
                                                 lb=lb))


def _ext_col(layout, j, rr, N, RR):
    """The digit extension's column (the per-step forms' ext [G, RT]) of
    digit row rr of coefficient block j, first coefficient."""
    return rr * N + j * 128 if layout == "thin" else (j * RR + rr) * 128


@pytest.mark.parametrize("N", [256, 1024], ids=["NB2", "NB8"])
@pytest.mark.parametrize("Gp", [16, 48])
@pytest.mark.parametrize("form", list(LOOP_FORMS))
def test_loop_plan_covers_every_product_once(form, Gp, N):
    """Every (K, gate, contraction row, column) product of a step is made
    exactly once across the clusters' CTAs, each from the digit column and
    with the sign that tkey.k_tile_order (the K-major product) gives it;
    every output word has one owner."""
    _, L, layout, lb = LOOP_FORMS[form]
    p = dataclasses.replace(P, N=N)
    cfg = (layout, L, lb, 1)
    plan = tkey.loop_plan(p, cfg, Gp)
    cw, gt = plan["cw"], plan["gt"]
    assert (cw, gt) == (tkey.LOOP_CW, tkey.LOOP_GT)
    NB, RR = N // 128, p.l + lb
    RT, C = RR * N, 2 * L * 128
    tiles = plan["gate_tiles"]
    assert plan["NB"] == NB and tiles[0][0] == 0 and tiles[-1][1] == Gp
    assert all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))
    assert all(e - g == gt for g, e in tiles)
    want = {}
    for K in range(NB):
        for t, acol, _, wrap in tkey.k_tile_order(K, layout, RT, N, RR):
            want[(K, t * 128)] = (acol, wrap)
    seen, owners = {}, {}
    for u, ct in plan["clusters"]:
        cols = plan["columns"][(u, ct)]
        assert len(cols) == L * cw
        for b in range(NB):
            K_own = plan["reduces"][b]
            for c in range(cw):
                for g in range(Gp):
                    key = (g, u, K_own * 128 + ct * cw + c)
                    owners[key] = owners.get(key, 0) + 1
            for K in range(NB):
                j, sign = plan["sources"][b][K]
                for rr, coord in enumerate(plan["chunks"][b]):
                    assert want[(K, coord)] == (
                        _ext_col(layout, j, rr, N, RR), sign < 0)
                    for col in cols:
                        seen[(K, coord, col)] = \
                            seen.get((K, coord, col), 0) + 1
    # k-tiles x their 128 rows x every gate tile: counted per k-tile
    assert set(seen.values()) == {1}
    assert len(seen) == NB * (RT // 128) * C
    assert set(owners.values()) == {1} and len(owners) == Gp * 2 * N


def _loop_model(rows, acc, slab, p, cfg):
    """The persistent form's step in plain torch, as the plan runs it: per
    cluster (u, ct) and CTA b, the partials of every stacked digit block j
    against the CTA's contraction block (k-tile by k-tile), negated where
    (b, K) wraps; the owner of output block K sums
    its cluster's partials, recombines the limbs and writes the other
    accumulator buffer (each word once).  Returns the final buffer."""
    layout, L, lb, M = cfg
    G = acc.shape[0]
    Gp = -(-G // tkey.BLOCK_G) * tkey.BLOCK_G
    plan = tkey.loop_plan(p, cfg, Gp)
    N, NB, ktc, cw = p.N, plan["NB"], plan["ktc"], plan["cw"]
    phys = slab.movedim(-1, 1).reshape(slab.shape[0], slab.shape[-1], -1)
    bufs = [torch.zeros((Gp, 2, N), dtype=torch.int64) for _ in range(2)]
    bufs[0][:G] = tops.to_u64(acc)
    rows = torch.cat([rows, rows.new_zeros((rows.shape[0], Gp - G))], 1)
    for i in range(phys.shape[0]):
        cur, nxt = bufs[i % 2], bufs[(i + 1) % 2]
        nxt.fill_(-1)
        d = tkey._digits_ref(cur, rows[i: i + 1], p, lb)
        dig = d.reshape(Gp, ktc, NB, 128).double()  # [g, rr, j, 128]
        for (u, ct), (g0, g1) in itertools.product(plan["clusters"],
                                                   plan["gate_tiles"]):
            B = phys[i][plan["columns"][(u, ct)]].double()    # [L*cw, KT]
            part = []
            for b in range(NB):
                s = torch.zeros((NB, g1 - g0, L * cw), dtype=torch.float64)
                for kt, coord in enumerate(plan["chunks"][b]):
                    a = dig[g0:g1, kt].permute(1, 0, 2)
                    s += a @ B[:, coord: coord + 128].t()  # [j, g, L*cw]
                for K in range(NB):
                    j, sign = plan["sources"][b][K]
                    if sign < 0:
                        s[j] = -s[j]
                part.append(s.to(torch.int64))
            for b in range(NB):
                K = plan["reduces"][b]
                tot = sum(part[r][plan["sources"][r][K][0]]
                          for r in range(NB))                  # [g, L*cw]
                tot = tot.reshape(g1 - g0, L, cw)
                v = sum(tot[:, li] << (8 * (4 - L + li)) for li in range(L))
                sl = slice(K * 128 + ct * cw, K * 128 + ct * cw + cw)
                assert (nxt[g0:g1, u, sl] == -1).all()    # one owner a word
                nxt[g0:g1, u, sl] = (cur[g0:g1, u, sl] + v) & MASK32
        assert (nxt >= 0).all()
    return tops.from_u64(bufs[phys.shape[0] % 2][:G])


@pytest.mark.parametrize("form", list(LOOP_FORMS))
def test_loop_model_equals_twin(form):
    """The plan's torch execution == the twin on a random slab of every
    layout the form serves (toy, n = 5: an odd count ends in the scratch
    buffer), at NB = 2."""
    tp = dataclasses.replace(P, n=5)
    rng = np.random.default_rng(len(form))
    slab = _random_slab(form, tp, tp.n, rng)
    G = 21
    tlwe0 = tops.u32_tensor(rng.integers(0, 1 << 32, (G, tp.n + 1),
                                         dtype=np.uint32), "cpu")
    tv = tops.u32_tensor(rng.integers(0, 1 << 32, tp.N, dtype=np.uint32),
                         "cpu")
    cfg, rows, acc = tkey._prepare(tlwe0, slab, tv, tp)
    assert torch.equal(_loop_model(rows, acc, slab, tp, cfg),
                       tkey._steps_ref(rows, acc, slab, tp, cfg))


def test_loop_model_equals_twin_at_nb8():
    """The same at N = 1024 (NB = 8, cggi128's ring: clusters of 8 CTAs,
    seven wrapped (b, K) pairs for b = 6), two key steps."""
    tp = dataclasses.replace(P, n=2, N=1024)
    rng = np.random.default_rng(8)
    slab = _random_slab("fat", tp, tp.n, rng)
    tlwe0 = tops.u32_tensor(rng.integers(0, 1 << 32, (5, tp.n + 1),
                                         dtype=np.uint32), "cpu")
    tv = tops.u32_tensor(rng.integers(0, 1 << 32, tp.N, dtype=np.uint32),
                         "cpu")
    cfg, rows, acc = tkey._prepare(tlwe0, slab, tv, tp)
    assert torch.equal(_loop_model(rows, acc, slab, tp, cfg),
                       tkey._steps_ref(rows, acc, slab, tp, cfg))


@pytest.mark.parametrize("G", [1, 5, 17, 48])
def test_loop_model_equals_twin_and_pallas(toy, toy_sk, toy_ek, G,
                                           monkeypatch):
    """The plan's execution on the default slab (fat, L=3, lb=2) of a real
    toy key == the twin == pallas_tk.blind_rotate_tkey (interpret mode),
    max |diff| 0."""
    monkeypatch.setenv("IYOKAN_PALLAS_INTERPRET", "1")
    L, lay, lb = tops.tkey_default_config(P)
    slab = tpm.tkey_kernel_key(toy_ek.bk, P, L, lay, lb=lb)
    kc = tkey.k_contiguous(slab)
    rng = np.random.default_rng(200 + G)
    ct = jhost.encrypt_bits(toy_sk, rng.integers(0, 2, G, dtype=np.uint8),
                            rng)
    testv = np.full(P.N, P.mu, np.uint32)
    tl, tv = tops.u32_tensor(ct, "cpu"), tops.u32_tensor(testv, "cpu")
    cfg, rows, acc = tkey._prepare(tl, kc, tv, P)
    got = _loop_model(rows, acc, kc, P, cfg)
    assert torch.equal(got, tkey._steps_ref(rows, acc, kc, P, cfg))
    want = pallas_tk.blind_rotate_tkey(jnp.asarray(ct), jnp.asarray(slab),
                                       jnp.asarray(testv), toy)
    np.testing.assert_array_equal(tops.u32_numpy(got), np.asarray(want))


def test_route_form():
    """Small batches take the persistent form on the layouts it serves
    (fat, thin), the others the mma.sync form up to WGMMA_MIN_G (the
    unrolled slab's and fat2's too: it does not serve them), then the
    wgmma form."""
    lo, wg = tkey.LOOP_MAX_G, tkey.WGMMA_MIN_G
    assert 16 < lo <= wg
    assert tkey.LOOP_ROUTED == ("fat", "thin")
    for layout in ("fat", "thin", "unrolled", "fat2"):
        routed = layout in tkey.LOOP_ROUTED
        assert tkey.route_form(layout, 16) == ("loop" if routed else "mma")
        assert tkey.route_form(layout, lo - 16) == ("loop" if routed
                                                     else "mma")
        assert tkey.route_form(layout, lo) == ("mma" if lo < wg else "wgmma")
        assert tkey.route_form(layout, wg - 16) == "mma"
        assert tkey.route_form(layout, wg) == "wgmma"
        assert tkey.route_form(layout, 2048) == "wgmma"
    assert set(tkey.FORM_LAUNCHES) == {"loop", "wgmma", "mma"}


@pytest.mark.parametrize("layout", ["fat2", "unrolled"])
def test_loop_form_refuses_layouts_it_does_not_serve(toy_ek, layout):
    """The persistent form serves neither fat2 nor the unrolled slab: the
    plan and a forced launch raise before anything is built or
    launched."""
    if layout == "unrolled":
        bku = toy_ek.bku.reshape(toy_ek.bku.shape[0], 6 * P.l, 2, P.N)
        slab = tpm.tkey_kernel_key(bku, P, 3, "fat", lb=2)
    else:
        slab = tpm.tkey_kernel_key(toy_ek.bk, P, 3, "fat2", lb=2)
    slab = tkey.k_contiguous(slab)
    cfg = tkey.slab_config(slab, P)
    assert cfg[0] == layout
    with pytest.raises(ValueError, match=layout):
        tkey.loop_plan(P, cfg, 16)
    acc = torch.zeros((16, 2, P.N), dtype=torch.int32)
    rows = torch.zeros((slab.shape[0] * cfg[3], 16), dtype=torch.int32)
    with pytest.raises(ValueError, match=layout):
        tkey._steps_kernel(rows, acc, slab, P, cfg, form="loop")


def test_loop_plan_refuses_bad_batches():
    """A batch that is not a positive multiple of the gate tile raises."""
    fat = ("fat", 3, 2, 1)
    for Gp in (0, 24, -16):
        with pytest.raises(ValueError):
            tkey.loop_plan(P, fat, Gp)


def test_loop_stage_bytes():
    """The exchange buffer: two parities of digit rows and the partials
    of the 8 clusters, then the barrier's 128 bytes (cggi128: 8 KiB of
    rows a k-tile and cluster parity, 32 KiB of partials a cluster)."""
    p = tparams.CGGI128
    lb = 2
    ktc, NB = p.l + lb, p.N // 128
    assert tkey.loop_stage_bytes(p, lb) == \
        8 * (2 * ktc * NB * 16 * 128 + NB * NB * 16 * 32 * 4) + 128


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #


def _card_args(toy_sk, slab, G, seed):
    rng = np.random.default_rng(seed)
    ct = jhost.encrypt_bits(toy_sk, rng.integers(0, 2, G, dtype=np.uint8),
                            rng)
    return (tops.u32_tensor(ct, "cuda"), tkey.k_contiguous(slab, "cuda"),
            tops.u32_tensor(np.full(P.N, P.mu, np.uint32), "cuda"), P)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [16, 32, 64, 112, 128])
@pytest.mark.parametrize("form", list(LOOP_FORMS))
def test_loop_form_equals_twin_on_card(toy_sk, slabs, form, G):
    """The persistent form == the twin (max |diff| 0), eagerly (one launch
    counted, the plan as launched) and as a CUDA graph replayed twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    args = _card_args(toy_sk, slabs[form], G, 300 + G)
    want = tkey.blind_rotate_tkey_ref(*args)
    before = tkey.FORM_LAUNCHES["loop"]
    got = tkey.blind_rotate_tkey(*args, form="loop")
    torch.cuda.synchronize()
    assert tkey.FORM_LAUNCHES["loop"] == before + 1
    assert torch.equal(got, want), (form, G)
    plan = tkey.LAST_LOOP
    assert plan["cluster_ctas"] == P.N // 128
    assert (plan["cw"], plan["gt"]) == (tkey.LOOP_CW, tkey.LOOP_GT)
    assert plan["clusters"] * plan["cw"] == 256
    assert plan["clusters_held"] >= plan["clusters"]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tkey.blind_rotate_tkey(*args, form="loop")
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want), (form, G, "replay")


@pytest.mark.cuda
def test_loop_form_refuses_fat2_on_card(toy_sk, toy_ek):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    slab = tpm.tkey_kernel_key(toy_ek.bk, P, 3, "fat2", lb=2)
    args = _card_args(toy_sk, slab, 16, 1)
    with pytest.raises(ValueError, match="fat2"):
        tkey.blind_rotate_tkey(*args, form="loop")
    assert tkey.blind_rotate_tkey(*args).shape == (16, 2, P.N)


@pytest.mark.cuda
def test_loop_form_on_a_side_stream(toy_sk, slabs):
    """Two launches on two streams, each with its own barrier word: both
    == the twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    args = _card_args(toy_sk, slabs["fat"], 16, 7)
    want = tkey.blind_rotate_tkey_ref(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        a = tkey.blind_rotate_tkey(*args, form="loop")
    b = tkey.blind_rotate_tkey(*args, form="loop")
    torch.cuda.synchronize()
    assert torch.equal(a, want) and torch.equal(b, want)


# --------------------------------------------------------------------------- #
# the variant specs of tools/br_variants.py
# --------------------------------------------------------------------------- #

# each edit's expected matches, in order: the ablation removes one after
# another the grid barrier, the digits, the A gather (load and wait), the
# two cluster barriers, the product, the reduction, and the slab's wait and
# reads (the per-step refill, the first loads); the profile flips one
# switch
K1_SPECS = {
    "k1_loop_ablation.json": (
        ["base", "no-grid-barrier", "no-digits", "no-gather",
         "no-cluster-barriers", "no-product", "no-reduction", "no-slab"],
        [1, 1, 1, 2, 1, 1, 1, 1, 1]),
    "k1_loop_profile.json": (["profile"], [1]),
}


@pytest.mark.parametrize("name", sorted(K1_SPECS))
def test_k1_loop_specs_match_their_source(name, tmp_path):
    """Every edit of the persistent form's variant specs matches its source
    as often as it should (on the sources of the variant before it, as
    tools/br_variants.py applies a cumulative spec), and the tool prepares
    each variant as an edited copy of csrc/."""
    import os
    import re

    from iyokan_tpu_torch.ops import nvcc
    from iyokan_tpu_torch.tools import br_variants
    spec = br_variants.load_spec(os.path.join(
        os.path.dirname(nvcc.CSRC), "tools", name))
    variants, counts = K1_SPECS[name]
    assert list(spec) == variants
    text = open(os.path.join(nvcc.CSRC, "tkey_loop.cuh")).read()
    got = []
    for edits in spec.values():
        for fn, pat, rep in edits:
            assert fn == "tkey_loop.cuh"
            got.append(len(re.findall(pat, text)))
            text = re.sub(pat, rep, text)
    assert got == counts
    dirs = dict(br_variants.prepare(spec, str(tmp_path)))
    assert len(dirs) == len(spec)


@pytest.mark.parametrize("unrolled", [False, True])
def test_variant_tool_random_slab(unrolled):
    """tools/br_variants.py's random slab for the persistent form's timing:
    K-contiguous, at the route's default limbs and lb, read by slab_config
    as fat (M = 1, n steps) or unrolled (M = 3, ceil(n/2) steps)."""
    from iyokan_tpu_torch.tools import br_variants
    slab = br_variants.random_slab(P, unrolled, "cpu")
    layout, L, lb, M = tkey.slab_config(slab, P)
    assert (layout, M) == (("unrolled", 3) if unrolled else ("fat", 1))
    assert (L, "fat", lb) == tops.tkey_default_config(P)
    assert slab.shape[0] == (-(-P.n // 2) if unrolled else P.n)
    assert tkey.is_k_contiguous(slab)
    assert {f"tkey_{f} fat" for f in tkey.FORM_LAUNCHES} <= set(
        br_variants.SOURCE_OF)
