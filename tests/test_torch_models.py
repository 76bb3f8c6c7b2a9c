"""Port vs JAX: the DUNE encoder (ObsPointNet) and its checkpoint loaders."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neupan_tpu.models import obs_point_net as jnet
from neupan_torch.models import ObsPointNet, load_checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODELS = ("diff_robot_default", "acker_robot_default", "polygon_robot")


@pytest.mark.parametrize("name", MODELS)
def test_encoder_matches_jax_on_shipped_checkpoints(name):
    path = os.path.join(ROOT, "examples", "model", name, "model.npz")
    pts = np.random.default_rng(0).uniform(-6, 6, (10000, 2)).astype(np.float32)
    ref = np.asarray(jnet.forward(jnet.load_checkpoint(path), jnp.asarray(pts)))
    net = load_checkpoint(path, device="cpu")
    with torch.no_grad():
        out = net(torch.from_numpy(pts)).numpy()
    assert out.shape == ref.shape
    # float32 noise: on these 10k points both forwards sit a few 1e-6 from
    # a float64 forward (the frameworks sum the 32-wide products and the
    # LayerNorm moments in different orders, and LayerNorm + tanh amplify
    # it), so the bound is the 1e-5 the DUNE comparison uses for mu
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_from_jax_params_and_reference_state_dict_layout(tmp_path):
    """from_jax_params transposes w_i (in, out) into Linear.weight (out, in);
    the state dict keys sit at the reference MLP indices, so the JAX
    package's own .pth converter reads it back to the same parameters, and
    a saved .pth loads through load_checkpoint."""
    params = {k: np.asarray(v) for k, v in
              jnet.init_params(jax.random.PRNGKey(3), 2, 5).items()}
    net = ObsPointNet.from_jax_params(params, device="cpu")
    assert net.MLP[13].out_features == 5
    back = jnet.params_from_torch_state_dict(net.state_dict())
    for k, v in params.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v)

    pts = np.random.default_rng(1).uniform(-3, 3, (500, 2)).astype(np.float32)
    ref = np.asarray(jnet.forward(params, jnp.asarray(pts)))
    with torch.no_grad():
        np.testing.assert_allclose(net(torch.from_numpy(pts)).numpy(), ref, atol=1e-6)

    pth = str(tmp_path / "model.pth")
    torch.save(net.state_dict(), pth)
    net2 = load_checkpoint(pth, device="cpu")
    for (k1, v1), (k2, v2) in zip(net.state_dict().items(), net2.state_dict().items()):
        assert k1 == k2
        torch.testing.assert_close(v1, v2, rtol=0, atol=0)
