"""Port vs JAX: DUNE training (labels, loss, optimizers, schedule, trainer).

Held against tests/golden/torch/dune_labels.npz and dune_train.npz
(``scripts/make_torch_goldens.py dune_labels dune_train``): JAX's labels on
three geometries, and JAX's ``DuneTrainer.start`` at 2,048 points, batch
256, 4 epochs with each optimizer, with every random draw recorded (the
permutations, the rotations, the validation's rotation, the init), which
the port's ``run_epoch`` is fed: ``jax.random`` cannot be reproduced in
torch. No JAX training epoch is compiled here.
"""

import json
import os
import re

import jax  # noqa: F401  (JAX and PyTorch share this process: both are imported up front)
import numpy as np
import optax
import pytest
import torch

from neupan_torch.models import ObsPointNet, to_jax_params
from neupan_torch.robot import Robot
from neupan_torch.training import DuneTrainer, dual_ascent_labels, polygon_distance_labels
from neupan_torch.training.dune_train import _loss_terms, eval_losses, rotation, run_epoch
from neupan_torch.training.labels import polygon_labels
from neupan_torch.training.optim import Adam, exponential_decay
from scripts.make_torch_goldens import DUNE_GEOMETRIES, DUNE_TRAIN, dune_label_points

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden", "torch")
PARAM_NAMES = ([f"{p}{i}" for i in range(6) for p in ("w", "b")]
               + [f"ln{j}_{s}" for j in range(3) for s in ("scale", "bias")])
# neupan_tpu/training/dune_train.py:DuneTrainer.start's train_dict.json keys
TRAIN_DICT_KEYS = ["data_size", "data_range", "batch_size", "epoch", "valid_freq",
                   "save_freq", "lr", "lr_decay", "decay_freq", "robot_G", "robot_h"]
NUM = r"[0-9.]+e[-+][0-9]+"
EPOCH_LINE = re.compile(rf"^Epoch (\d+)/(\d+) lr {NUM} \| mu {NUM}/{NUM} dist {NUM}/{NUM} "
                        rf"fa {NUM}/{NUM} fb {NUM}/{NUM}$")


def load(name):
    with np.load(os.path.join(GOLDEN, f"{name}.npz")) as g:
        return {k: g[k] for k in g.files}


@pytest.fixture(scope="module")
def labels_golden():
    return load("dune_labels")


@pytest.fixture(scope="module")
def train_golden():
    return load("dune_train")


t = torch.from_numpy


def diff_geometry():
    robot = Robot.create(**DUNE_GEOMETRIES["diff"])
    return robot.G.astype(np.float32), robot.h.astype(np.float32)


@pytest.mark.parametrize("name", list(DUNE_GEOMETRIES))
def test_labels_match_jax(labels_golden, name):
    """d to 1e-5 (1 + d) on every point; mu to 1e-5 where both packages
    pick the same active faces (the same support of mu). A point whose
    projection lies within the 1e-4 (1 + |h|) threshold of a second face
    may flip between one and two active faces on a rounding; none does on
    these points (inside, within 0.5 m of each vertex, far out)."""
    g = {k.split("__")[1]: v for k, v in labels_golden.items() if k.startswith(f"{name}__")}
    robot = Robot.create(**DUNE_GEOMETRIES[name])
    np.testing.assert_allclose(robot.G.astype(np.float32), g["G"], rtol=0, atol=0)
    np.testing.assert_allclose(robot.h.astype(np.float32), g["h"], rtol=0, atol=0)
    np.testing.assert_array_equal(dune_label_points(robot.vertices), g["points"])
    mu, d, act = (a.numpy() for a in polygon_labels(t(g["G"]), t(g["h"]), t(g["points"])))
    assert np.all(np.abs(d - g["d"]) <= 1e-5 * (1.0 + g["d"]))
    same = np.all((mu > 0) == (g["mu"] > 0), axis=1)
    assert (~same).sum() == 0, np.flatnonzero(~same)
    np.testing.assert_allclose(mu[same], g["mu"][same], rtol=0, atol=1e-5)
    # the support is the active set: an inside point has none, an outside one 1 or 2
    inside = g["d"] == 0
    assert not act[inside].any() and np.all(act[~inside].sum(1) >= 1)
    assert inside.sum() >= len(inside) // 4 and (act.sum(1) == 2).sum() > 100


def test_dual_ascent_labels(labels_golden):
    """Against JAX's ``dual_ascent_labels`` (same 200 ascent steps of 30
    Dykstra iterations) to 1e-5; against the closed form as
    tests/test_training.py:53-63 bounds it: mean |d| error < 5e-2, max < 0.3
    (the ball projection is approximated by scaling)."""
    G, h = t(labels_golden["diff__G"]), t(labels_golden["diff__h"])
    pts = t(labels_golden["dual__points"])
    mu, d = dual_ascent_labels(G, h, pts)
    np.testing.assert_allclose(mu.numpy(), labels_golden["dual__mu"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(d.numpy(), labels_golden["dual__d"], rtol=0, atol=1e-5)
    _, d_exact = polygon_distance_labels(G, h, pts)
    err = (d - d_exact).abs().numpy()
    assert err.mean() < 5e-2 and err.max() < 0.3


def _golden_net(g, opt):
    return ObsPointNet.from_jax_params({k: g[f"{opt}__init__{k}"] for k in PARAM_NAMES}, "cpu")


def _splits(g, opt):
    pts, mu, d = (t(g[f"{opt}__{k}"]) for k in ("pts", "mu", "d"))
    n_train = int(0.8 * len(pts))
    return (pts[:n_train], mu[:n_train], d[:n_train]), (pts[n_train:], mu[n_train:], d[n_train:])


def test_dataset_labels_and_loss_terms_at_fixed_weights(train_golden):
    """The golden dataset's labels from the port, and the four loss terms of
    JAX's init on the first batch of epoch 0 under its rotation, to 1e-5
    relative."""
    g, opt = train_golden, "adam_l2"
    G, h = t(g["G"]), t(g["h"])
    mu, d = polygon_distance_labels(G, h, t(g[f"{opt}__pts"]))
    assert np.all(np.abs(d.numpy() - g[f"{opt}__d"]) <= 1e-5 * (1.0 + g[f"{opt}__d"]))
    np.testing.assert_allclose(mu.numpy(), g[f"{opt}__mu"], rtol=0, atol=1e-5)
    (p, m, dd), _ = _splits(g, opt)
    first = torch.as_tensor(g[f"{opt}__perm"][0][:int(g["batch_size"])]).long()
    R = rotation(torch.tensor(g[f"{opt}__thetas"][0][0]))
    with torch.no_grad():
        terms = torch.stack(_loss_terms(_golden_net(g, opt), p[first], m[first], dd[first],
                                        G, h, R)).numpy()
    np.testing.assert_allclose(terms, g[f"{opt}__fixed_loss"], rtol=1e-5, atol=0)


def test_schedule_matches_optax_exactly(train_golden):
    """The learning rate of every update: the golden run's (2-epoch
    staircase, lr 1e-3) and the default run's around its decay steps
    (lr 5e-5, x0.5 every 1500 epochs of 312 batches) and with a decay rate
    that is no power of two, bit for bit against optax."""
    g = train_golden
    nb = g["adam_l2__thetas"].shape[1]
    sched = exponential_decay(float(g["lr"]), int(g["decay_freq"]) * nb, float(g["lr_decay"]))
    counts = torch.arange(len(g["adam_l2__sched"]))
    np.testing.assert_array_equal(sched(counts).numpy(), g["adam_l2__sched"])
    ts = 1500 * 312
    counts = np.array([0, 1, ts - 1, ts, ts + 1, 2 * ts - 1, 2 * ts, 3 * ts, 5000 * 312 - 1])
    for decay in (0.5, 0.7):
        ref = optax.exponential_decay(5e-5, transition_steps=ts, decay_rate=decay, staircase=True)
        mine = exponential_decay(5e-5, ts, decay)(torch.as_tensor(counts)).numpy()
        np.testing.assert_array_equal(mine, np.asarray([ref(int(c)) for c in counts]))


@pytest.mark.parametrize("optimizer", ["adam_l2", "adamw"])
def test_four_epochs_match_jax(train_golden, optimizer):
    """JAX's 4-epoch run (24 updates at lr 1e-3, halved after 12) replayed
    on the port with JAX's draws. Per-epoch train and validation loss
    terms to 1e-5 relative (measured 3e-7). Weights: Adam's first steps
    are signs, so a gradient element that rounds across zero moves its
    weight by 2 lr; the bound is stated in lr x steps = 0.024: every
    weight within 1e-4 of it (2.4e-6; measured 1.2e-7, none beyond) but
    at most 0.5% of the 4,644, which are counted and held within 2 lr x
    steps."""
    g = train_golden
    G, h = t(g["G"]), t(g["h"])
    net = _golden_net(g, optimizer)
    train, valid = _splits(g, optimizer)
    nb = g[f"{optimizer}__thetas"].shape[1]
    sched = exponential_decay(float(g["lr"]), int(g["decay_freq"]) * nb, float(g["lr_decay"]))
    opt = Adam(list(net.parameters()), sched, optimizer)
    for e in range(int(g["epoch"]) + 1):
        tr = run_epoch(net, opt, train, torch.as_tensor(g[f"{optimizer}__perm"][e]).long(),
                       t(g[f"{optimizer}__thetas"][e]), G, h)
        va = eval_losses(net, valid, torch.tensor(g[f"{optimizer}__theta_valid"][e]), G, h)
        np.testing.assert_allclose(tr.numpy(), g[f"{optimizer}__train_loss"][e], rtol=1e-5)
        np.testing.assert_allclose(va.numpy(), g[f"{optimizer}__valid_loss"][e], rtol=1e-5)
    assert int(opt.count) == 4 * nb
    scale = float(g["lr"]) * 4 * nb
    final = to_jax_params(net)
    diff = np.concatenate([np.abs(final[k] - g[f"{optimizer}__trainer_final__{k}"]).ravel()
                           for k in PARAM_NAMES])
    assert diff.size == 4644
    beyond = diff > 1e-4 * scale
    assert beyond.sum() <= 0.005 * diff.size and diff.max() <= 2 * scale, (beyond.sum(), diff.max())


def test_adam_l2_and_adamw_differ_only_by_where_decay_enters():
    """One update from zero moments: adam_l2 folds 1e-4 p into the gradient
    before the moments, adamw adds 1e-4 p to the Adam direction."""
    p = torch.tensor([1.0, -2.0, 3.0])
    g = torch.tensor([1e-3, 0.5, -2.0])
    sched = exponential_decay(0.1, 10, 0.5)
    a, b = p.clone(), p.clone()
    Adam([a], sched, "adam_l2").step([a], [g])
    Adam([b], sched, "adamw").step([b], [g])
    gl = g + 1e-4 * p
    np.testing.assert_allclose(a.numpy(), (p - 0.1 * gl / (gl.abs() + 1e-8)).numpy(), rtol=1e-6)
    np.testing.assert_allclose(b.numpy(), (p - 0.1 * (g / (g.abs() + 1e-8) + 1e-4 * p)).numpy(),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="optimizer"):
        Adam([a], sched, "sgd")


def test_short_cpu_run_lowers_the_loss_and_writes_jax_files(tmp_path):
    """tests/test_training.py's short run (2,000 points, 31 epochs of
    batch 128, lr 1e-3) on the port: the summed loss falls, the trained
    encoder beats its seeded init on distance MSE, and the files carry the
    JAX trainer's names, keys and line formats; its checkpoints load in
    the JAX package."""
    from neupan_tpu.models import obs_point_net as jnet

    G, h = diff_geometry()
    trainer = DuneTrainer(G, h, str(tmp_path), device="cpu")
    enc, ckpt = trainer.start(data_size=2000, epoch=30, batch_size=128, valid_freq=10,
                              save_freq=15, lr=1e-3, save_loss=True)
    assert ckpt == str(tmp_path / "model_30.npz")
    assert sorted(os.listdir(tmp_path)) == ["loss.npy", "model_0.npz", "model_15.npz",
                                            "model_30.npz", "results.txt", "train_dict.json"]
    loss = np.load(tmp_path / "loss.npy")
    assert loss.shape == (31,) and loss[-5:].mean() < loss[:5].mean(), loss

    with open(tmp_path / "train_dict.json") as f:
        td = json.load(f)
    assert list(td) == TRAIN_DICT_KEYS and td["robot_G"] == G.tolist()
    lines = (tmp_path / "results.txt").read_text().splitlines()
    assert lines[0].startswith("train config: {'data_size': 2000")
    assert re.fullmatch(r"dataset \(2000 pts\) labeled in [0-9.]+s", lines[1])
    epochs = [EPOCH_LINE.match(ln) for ln in lines[2:]]
    assert all(epochs) and [m.group(1) for m in epochs] == ["0", "10", "20", "30"]

    params = jnet.load_checkpoint(ckpt)
    assert sorted(params) == sorted(PARAM_NAMES)
    for k, v in to_jax_params(enc).items():
        np.testing.assert_array_equal(np.asarray(params[k]), v)

    pts = torch.as_tensor(np.random.default_rng(3).uniform(-25, 25, (500, 2)), dtype=torch.float32)
    Gt, ht = t(G), t(h)
    mu_l, d_l = polygon_distance_labels(Gt, ht, pts)

    def dist_mse(net):
        with torch.no_grad():
            d = torch.sum(net(pts) * (pts @ Gt.T - ht.reshape(1, -1)), dim=1)
        return float(torch.mean((d - d_l) ** 2))

    assert dist_mse(enc) < dist_mse(ObsPointNet.seeded(2, 4, seed=5, device="cpu"))


def test_start_draws_on_its_generator_and_trains_the_given_encoder(tmp_path):
    """Same seed, same run; the encoder passed in is the one trained (in
    place, its version counters moving), and a YAML's "5e-5" string lr is
    read as a number."""
    G, h = diff_geometry()
    runs = []
    for i in range(2):
        enc = ObsPointNet.seeded(2, 4, seed=0, device="cpu")
        version = enc.MLP[0].weight._version
        out, _ = DuneTrainer(G, h, str(tmp_path / str(i)), device="cpu").start(
            enc, data_size=600, epoch=1, batch_size=128, lr="1e-3", save_loss=True)
        assert out is enc and enc.MLP[0].weight._version > version
        runs.append((to_jax_params(enc), np.load(tmp_path / str(i) / "loss.npy")))
    for k in PARAM_NAMES:
        np.testing.assert_array_equal(runs[0][0][k], runs[1][0][k])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


def test_test_harness_runs_the_kernel_route(tmp_path):
    """``DuneTrainer.test`` on the CPU: the plain version of the fused MLP,
    equal to the module, with JAX's result keys and test_results.txt."""
    G, h = diff_geometry()
    trainer = DuneTrainer(G, h, str(tmp_path), device="cpu")
    enc = ObsPointNet.seeded(2, 4, seed=0, device="cpu")
    res = trainer.test(enc, data_size_list=(100, 300))
    assert [r["data_size"] for r in res] == [100, 300]
    for r in res:
        assert {"inference_time", "mu_loss", "distance_loss", "fa_loss", "fb_loss"} <= set(r)
        assert r["kernel_vs_module_max_abs"] <= 1e-5 and r["device"] == "cpu"
    assert len((tmp_path / "test_results.txt").read_text().splitlines()) == 2


def test_chip_smoke_train_settings_equal_the_yaml():
    """chip_smoke.py's train path builds its planner from a dict (the card's
    machine is not promised pyyaml): it must equal
    examples/dune_train/dune_train_diff.yaml."""
    import yaml

    import chip_smoke

    with open(os.path.join(ROOT, "examples", "dune_train", "dune_train_diff.yaml")) as f:
        assert chip_smoke.DUNE_TRAIN_DIFF == yaml.safe_load(f)
