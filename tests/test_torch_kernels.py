"""The port's four kernels: plain versions vs the JAX Pallas kernels.

On the CPU every wrapper runs its plain PyTorch version; these tests hold
that version against the Pallas kernel it replaces, run in interpret mode
as tests/test_pallas.py runs it. The CUDA kernels are held against their
plain versions in tests/test_torch_gpu.py, on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neupan_tpu.ops.pallas.admm import admm_iterate as j_admm
from neupan_tpu.ops.pallas.polish import box_candidate as j_box
from neupan_tpu.ops.pallas.select import select_topk_flow_pallas as j_select
from neupan_torch.ops.kernels import admm as AD
from neupan_torch.ops.kernels import polish as PO
from neupan_torch.ops.kernels import select as SE
from neupan_torch.ops.kernels import sweep as SW
from tests.test_torch_gpu import (ADMM_KW, admm_inputs, polish_inputs, select_inputs,
                                  sweep_inputs, t32)


# -- plain versions vs the Pallas kernels (CPU) ---------------------------------

def test_select_plain_matches_pallas_interpret():
    """Identical indices (ties to the lower index) at T+1=5, P=256, K=6,
    with a mask that leaves fewer valid points than a full frame."""
    pts, vels, mask, R, trans, dt, (V, G, h) = select_inputs()
    K = 6
    keys, idx = SE.select_topk_flow(torch.from_numpy(pts), torch.from_numpy(vels),
                                    torch.from_numpy(mask), torch.from_numpy(R),
                                    torch.from_numpy(trans), dt, torch.from_numpy(V),
                                    torch.from_numpy(G), torch.from_numpy(h), K)
    for b in range(pts.shape[0]):
        kj, ij = j_select(jnp.asarray(pts[b]), jnp.asarray(vels[b]), jnp.asarray(mask[b]),
                          jnp.asarray(R[b]), jnp.asarray(trans[b]), dt, jnp.asarray(V),
                          jnp.asarray(G), jnp.asarray(h), K, interpret=True)
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ij))
        np.testing.assert_allclose(keys[b].numpy(), np.asarray(kj), rtol=1e-6, atol=1e-6)
    assert idx.dtype == torch.int32 and keys.shape == (2, 5, K)


def test_select_masked_slots_repeat_the_reference_tie_rule():
    """With fewer valid points than K the trailing slots carry the 1e9 key
    and the lowest-index 1e9 point, as the reference's argmin passes do."""
    pts, vels, mask, R, trans, dt, (V, G, h) = select_inputs(B=1)
    mask[:] = False
    mask[0, [5, 9]] = True
    keys, idx = SE.select_topk_flow(*(torch.from_numpy(a) for a in (pts, vels, mask, R, trans)),
                                    dt, *(torch.from_numpy(a) for a in (V, G, h)), 4)
    kj, ij = j_select(*(jnp.asarray(a[0]) for a in (pts, vels, mask, R, trans)), dt,
                      *(jnp.asarray(a) for a in (V, G, h)), 4, interpret=True)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(ij))
    assert (keys[0, :, :2] < 5e8).all() and (keys[0, :, 2:] == 1e9).all()


@pytest.mark.parametrize("B,n", [(4, 30), (130, 18), (7, 33)])
def test_sweep_plain_matches_f64_inverse(B, n):
    Mt = sweep_inputs(B, n)
    X = SW.sweep_spd_inverse(t32(Mt)).numpy()
    X64 = np.linalg.inv(Mt)
    rel = np.abs(X - X64).max() / np.abs(X64).max()
    assert rel < 3e-5, rel


def test_admm_plain_matches_pallas_interpret():
    """w, z to f32 tightness; y to the level set by 50 iterations of
    reordered float32 accumulation (tests/test_pallas.py's tolerances)."""
    args = admm_inputs()
    w, z, y = AD.admm_iterate(*(t32(a) for a in args), **ADMM_KW)
    wj, zj, yj = j_admm(*(jnp.asarray(a) for a in args), has_soft=True, interpret=True,
                        **ADMM_KW)
    np.testing.assert_allclose(w.numpy(), np.asarray(wj), atol=1e-4)
    np.testing.assert_allclose(z.numpy(), np.asarray(zj), atol=1e-4)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-2, atol=1e-3)


def test_polish_plain_matches_pallas_interpret():
    """At k=16, na=8 the interpret-mode kernel compiles in a few seconds;
    the main-path shape (k=30, na=18) is held on the card, plain vs CUDA."""
    args = polish_inputs(k=16, na=8)
    out = PO.box_candidate(*(t32(a) for a in args), refine=7)
    ref = j_box(*(jnp.asarray(a) for a in args), refine=7, interpret=True)
    for o, r in zip(out, ref):
        o, r = o.numpy(), np.asarray(r)
        assert np.abs(o - r).max() / max(np.abs(r).max(), 1e-9) < 2e-4


# -- wrappers: checks, no fallback, launch counts ----------------------------------

def test_wrappers_reject_what_the_kernels_do_not_take():
    M = t32(sweep_inputs(2, 8))
    with pytest.raises(ValueError, match="n <= 96"):
        SW.sweep_spd_inverse(torch.zeros((1, 97, 97)))
    with pytest.raises(TypeError):
        SW.sweep_spd_inverse(M.double())
    with pytest.raises(ValueError, match="contiguous"):
        SW.sweep_spd_inverse(M.transpose(1, 2))
    with pytest.raises(ValueError):
        SW.sweep_spd_inverse(torch.zeros((0, 4, 4)))
    # a device that is neither the CPU nor a card raises instead of falling back
    with pytest.raises(ValueError, match="unsupported device"):
        SW.sweep_spd_inverse(torch.zeros((1, 4, 4), device="meta"))
    args = [t32(a) for a in admm_inputs(B=2, m=20, k=6)]
    with pytest.raises(ValueError, match="shape"):
        AD.admm_iterate(args[0], *args[1:5], args[5][:, :3], *args[6:], **ADMM_KW)
    with pytest.raises(ValueError, match="shared memory"):
        big = [torch.zeros(s) for s in ((1, 96, 96), (1, 600, 96))]
        AD.admm_iterate(big[0], big[1], torch.zeros(1, 96), *[torch.zeros(1, 600)] * 4,
                        torch.zeros(1, 96), torch.zeros(1, 600), torch.zeros(1, 600), **ADMM_KW)
    pts, vels, mask, R, trans, dt, (V, G, h) = select_inputs(B=1, P=16)
    with pytest.raises(ValueError, match="k must be"):
        SE.select_topk_flow(*(torch.from_numpy(a) for a in (pts, vels, mask, R, trans)), dt,
                            *(torch.from_numpy(a) for a in (V, G, h)), 17)
    with pytest.raises(TypeError, match="bool"):
        SE.select_topk_flow(*(torch.from_numpy(a) for a in (pts, vels)),
                            torch.from_numpy(mask).float(),
                            *(torch.from_numpy(a) for a in (R, trans)), dt,
                            *(torch.from_numpy(a) for a in (V, G, h)), 4)


def test_cpu_calls_run_the_plain_version_and_count_no_launch():
    wrappers = (SE.select_topk_flow, SW.sweep_spd_inverse, AD.admm_iterate, PO.box_candidate)
    before = [w.launches for w in wrappers]
    M = t32(sweep_inputs(3, 12))
    torch.testing.assert_close(SW.sweep_spd_inverse(M), SW.sweep_spd_inverse_plain(M),
                               rtol=0, atol=0)
    args = [t32(a) for a in polish_inputs(B=2, k=8, na=3)]
    for o, p in zip(PO.box_candidate(*args, refine=2), PO.box_candidate_plain(*args, refine=2)):
        torch.testing.assert_close(o, p, rtol=0, atol=0)
    assert [w.launches for w in wrappers] == before
