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


PARAM_ORDER = ([f"{p}{i}" for i in range(6) for p in ("w", "b")]
               + [f"ln{j}_{s}" for j in range(3) for s in ("scale", "bias")])


def test_port_checkpoint_loads_in_jax(tmp_path):
    """save_checkpoint writes the JAX package's .npz: its load_checkpoint
    reads the same parameters (bit for bit, keys in init_params' order) and
    its forward equals the port's to 1e-6."""
    from neupan_torch.models import save_checkpoint, to_jax_params

    net = ObsPointNet.seeded(2, 4, seed=7, device="cpu")
    path = str(tmp_path / "model_0.npz")
    save_checkpoint(path, net)
    with np.load(path) as data:
        assert list(data.files) == PARAM_ORDER
    params = jnet.load_checkpoint(path)
    for k, v in to_jax_params(net).items():
        np.testing.assert_array_equal(np.asarray(params[k]), v)
    pts = np.random.default_rng(4).uniform(-3, 3, (500, 2)).astype(np.float32)
    with torch.no_grad():
        mine = net(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(mine, np.asarray(jnet.forward(params, jnp.asarray(pts))),
                               rtol=0, atol=1e-6)


def test_jax_checkpoint_loads_in_port(tmp_path):
    """A checkpoint written by the JAX package (its save_checkpoint of its
    init_params) loads through the port's load_checkpoint: to_jax_params
    gives it back bit for bit, and the forwards agree to 1e-6."""
    from neupan_torch.models import to_jax_params

    params = jnet.init_params(jax.random.PRNGKey(9), 2, 4)
    path = str(tmp_path / "model_0.npz")
    jnet.save_checkpoint(path, params)
    net = load_checkpoint(path, device="cpu")
    back = to_jax_params(net)
    assert list(back) == PARAM_ORDER
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], np.asarray(v))
    pts = np.random.default_rng(5).uniform(-3, 3, (500, 2)).astype(np.float32)
    with torch.no_grad():
        mine = net(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(mine, np.asarray(jnet.forward(params, jnp.asarray(pts))),
                               rtol=0, atol=1e-6)


def test_train_dune_installs_weights_the_kernel_route_sees(tmp_path):
    """NeuPan.train_dune trains the planner's encoder in place; the fused
    MLP's packed weights (cached on the module, stamped by each parameter's
    version) are repacked, so dune_mlp on the trained encoder equals the
    module and no longer gives the seeded init's output."""
    from neupan_torch import NeuPan
    from neupan_torch.ops.kernels.mlp import dune_mlp

    yaml_file = os.path.join(ROOT, "examples", "dune_train", "dune_train_diff.yaml")
    planner = NeuPan.init_from_yaml(yaml_file, device="cpu")
    pts = torch.as_tensor(np.random.default_rng(6).uniform(-5, 5, (300, 2)), dtype=torch.float32)
    with torch.no_grad():
        before = dune_mlp(planner.encoder, pts)                 # packs the seeded weights
    encoder = planner.encoder
    path = planner.train_dune(epoch=1, data_size=1000, batch_size=128,
                              checkpoint_dir=str(tmp_path))
    assert planner.encoder is encoder and path == str(tmp_path / "model_0.npz")
    assert sorted(os.listdir(tmp_path)) == ["model_0.npz", "results.txt", "train_dict.json"]
    with torch.no_grad():
        after, module = dune_mlp(planner.encoder, pts), planner.encoder(pts)
    torch.testing.assert_close(after, module, rtol=0, atol=1e-6)
    assert float((after - before).abs().max()) > 1e-3
