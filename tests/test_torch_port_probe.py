"""The port's linear probe against the JAX package, on the CPU at a small
size (rn10, 16 px, 8-16 rows, 3 classes unless top-5 needs more).

The same numpy-seeded inputs go through the JAX function and the port's:

- ``cross_entropy_loss`` (rtol 1e-6);
- ``topk_accuracy`` / ``topk_correct`` on tie-free logits (exact; with
  ties ``torch.topk`` and ``jax.lax.top_k`` may rank equal logits apart);
- ``augment_batch``'s stack with ``color_ops=False`` on explicit crop and
  flip parameters against JAX ``simclr_transform`` (its draws replaced by
  those parameters), and ``eval_batch`` against ``eval_transform``
  (atol 1e-5, as ``test_torch_port_augment.py``);
- ``LinearClassifier`` transplanted from a JAX init (logits atol 1e-6);
- three probe steps from one transplanted encoder and classifier against
  the JAX composition ``SupConResNet.encode(train=False)`` +
  ``LinearClassifier`` + ``cross_entropy_loss`` + ``make_optimizer`` /
  ``make_lr_schedule``. Tolerances: features atol 1e-4, the pin of rn10's
  eval forward in ``test_torch_port_models.py``. The logits are bounded
  row by row from the measured differences (Cauchy-Schwarz): ``|dz_ik| <=
  |w_k| |df_i| + |dw_k| |f_i| + |db_k|``, plus the two packages' fp32
  rounding, ``2 gamma_512 sum_j |w_kj f_ij| + 2u |z_ik|`` (any summation
  order of 512 terms). The loss moves at most ``2 max |dz|`` (a row's
  cross-entropy has a gradient ``p - onehot`` in its logits, of L1 norm
  at most 2). The classifier after each
  step: atol 1e-5, rtol 1e-5, about ten times the measured ~1e-6 (three
  updates at lr <= 5 of gradients that move with the features' 1e-6).
- validation over a split that is not a multiple of ``val_batch_size``;
- the encoder bitwise unchanged by a probe run;
- the probe driver on ``--device cpu`` end to end from a tiny port
  pretrain's ``last.pth``, and the checkpoint bridges: port ``.pth`` ->
  JAX ``load_pretrained_variables``, a JAX-exported reference ``.pth`` ->
  the port, and port -> JAX -> port bitwise.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from simclr_pytorch_distributed_tpu.models import (
    LinearClassifier as JaxLinearClassifier,
    SupConResNet as JaxSupConResNet,
)
from simclr_pytorch_distributed_tpu.ops import augment as jaug
from simclr_pytorch_distributed_tpu.ops import losses as jlosses
from simclr_pytorch_distributed_tpu.ops import metrics as jmetrics
from simclr_pytorch_distributed_tpu.ops.schedules import make_lr_schedule as jax_schedule
from simclr_pytorch_distributed_tpu.train.state import make_optimizer as jax_optimizer
from simclr_pytorch_distributed_tpu.utils.checkpoint import (
    MODEL_LAYOUT_VERSION,
    _save_tree,
    _write_meta,
    load_pretrained_variables,
)
from simclr_pytorch_distributed_tpu.utils.torch_convert import (
    convert_reference_checkpoint,
    export_reference_checkpoint,
)
from simclr_pytorch_distributed_tpu_torch import config as config_lib
from simclr_pytorch_distributed_tpu_torch.models import LinearClassifier, SupConResNet
from simclr_pytorch_distributed_tpu_torch.ops.augment import (
    AugmentConfig,
    apply_views,
    augment_batch,
    eval_batch,
    sample_view_params,
)
from simclr_pytorch_distributed_tpu_torch.ops.losses import cross_entropy_loss
from simclr_pytorch_distributed_tpu_torch.ops.metrics import topk_accuracy, topk_correct
from simclr_pytorch_distributed_tpu_torch.ops.schedules import make_lr_schedule
from simclr_pytorch_distributed_tpu_torch.train import linear, supcon
from simclr_pytorch_distributed_tpu_torch.train.state import TrainState, make_optimizer
from simclr_pytorch_distributed_tpu_torch.utils.checkpoint import (
    load_classifier,
    load_model_state,
)
from simclr_pytorch_distributed_tpu_torch.utils.convert import (
    classifier_params_to_state_dict,
    classifier_state_dict_to_params,
    state_dict_to_variables,
    variables_to_state_dict,
)
from torch_threads import limit_threads

limit_threads()

CFG = AugmentConfig(size=12, mean=(0.5, 0.4, 0.3), std=(0.25, 0.2, 0.3), color_ops=False)
FEATURE_ATOL = 1e-4  # rn10's eval forward pin (test_torch_port_models.py)
# two fp32 dot products of 512 terms in any order, each within gamma_512 =
# 512u / (1 - 512u) of sum |w_j f_j|, and the bias add within u |z| each
ROUNDING = 2 * 512 * 2.0**-24 / (1 - 512 * 2.0**-24)


def tie_free_logits(rng, n, classes):
    """Rows whose values are distinct draws of a permutation, so no two
    logits of a row tie."""
    return np.stack([rng.permutation(classes) + rng.uniform(0.05, 0.95, classes)
                     for _ in range(n)]).astype(np.float32)


@pytest.mark.parametrize("n, classes, seed", [(8, 3, 0), (16, 10, 1), (13, 32, 2)])
def test_cross_entropy_matches_jax(n, classes, seed):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal((n, classes))).astype(np.float32)
    labels = rng.integers(0, classes, n).astype(np.int32)
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels)).item()
    want = float(jlosses.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("n, classes, ks, seed", [
    (8, 3, (1, 2), 0), (16, 10, (1, 5), 1), (12, 7, (1, 3, 5), 2), (16, 32, (1, 5, 10), 3),
])
def test_topk_matches_jax_on_tie_free_logits(n, classes, ks, seed):
    rng = np.random.default_rng(seed)
    logits = tie_free_logits(rng, n, classes)
    labels = rng.integers(0, classes, n).astype(np.int32)
    tl, tt = torch.from_numpy(logits), torch.from_numpy(labels)
    jl, jt = jnp.asarray(logits), jnp.asarray(labels)
    got = [float(a) for a in topk_accuracy(tl, tt, ks)]
    assert got == [float(a) for a in jmetrics.topk_accuracy(jl, jt, ks)]
    got_c = {k: int(v) for k, v in topk_correct(tl, tt, ks).items()}
    assert got_c == {k: int(v) for k, v in jmetrics.topk_correct(jl, jt, ks).items()}


def test_topk_above_the_class_count_counts_every_class():
    logits = torch.tensor([[0.1, 0.9, 0.5], [0.7, 0.2, 0.3]])
    labels = torch.tensor([0, 2])
    assert {k: int(v) for k, v in topk_correct(logits, labels).items()} == {1: 0, 5: 2}


def crop_flip_params(rng, n, height, width):
    h = rng.integers(4, height + 1, n).astype(np.float32)
    w = rng.integers(4, width + 1, n).astype(np.float32)
    return {
        "top": np.floor(rng.random(n) * (height - h + 1)).astype(np.float32),
        "left": np.floor(rng.random(n) * (width - w + 1)).astype(np.float32),
        "h": h, "w": w, "flip": rng.random(n) < 0.5,
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_crop_flip_stack_matches_jax_simclr_transform(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    n, height, width = 8, 16, 20
    images = rng.integers(0, 256, (n, height, width, 3)).astype(np.uint8)
    p = crop_flip_params(rng, n, height, width)
    got = apply_views(torch.from_numpy(images),
                      {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}, CFG).numpy()
    assert got.shape == (n, CFG.size, CFG.size, 3) and got.dtype == np.float32
    for i in range(n):
        # JAX simclr_transform with its two draws replaced by view i's
        # parameters: with color_ops off it crops, flips and normalizes
        monkeypatch.setattr(jaug, "random_resized_crop", lambda key, img, size, scale, i=i: (
            jaug.crop_and_resize(img, p["top"][i], p["left"][i], p["h"][i], p["w"][i], size)))
        monkeypatch.setattr(jaug, "random_horizontal_flip", lambda key, img, i=i: (
            img[:, ::-1, :] if p["flip"][i] else img))
        want = jaug.simclr_transform(jax.random.key(0), jnp.asarray(images[i]), CFG)
        np.testing.assert_allclose(got[i], np.asarray(want), atol=1e-5, err_msg=f"view {i}")


def test_augment_batch_draws_crop_and_flip_only():
    gen = torch.Generator().manual_seed(0)
    images = torch.randint(0, 256, (6, 16, 16, 3), dtype=torch.uint8)
    drawn = sample_view_params(gen, 6, 16, 16, CFG)
    assert sorted(drawn) == ["flip", "h", "left", "top", "w"]
    out = augment_batch(torch.Generator().manual_seed(0), images, CFG)
    np.testing.assert_array_equal(out.numpy(), apply_views(images, drawn, CFG).numpy())


def test_eval_batch_matches_jax():
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (8, 16, 16, 3)).astype(np.uint8)
    got = eval_batch(torch.from_numpy(images), CFG).numpy()
    want = np.asarray(jaug.eval_batch(jnp.asarray(images), CFG))
    np.testing.assert_allclose(got, want, atol=1e-5)


def jax_classifier(classes, seed):
    clf = JaxLinearClassifier(model_name="resnet10", num_classes=classes)
    return clf, clf.init(jax.random.key(seed), jnp.zeros((2, 512)))["params"]


def port_classifier(params, classes):
    clf = LinearClassifier("resnet10", classes)
    clf.load_state_dict(classifier_params_to_state_dict(params))
    return clf


def test_linear_classifier_transplanted_from_jax(tmp_path):
    clf, params = jax_classifier(3, 5)
    port = port_classifier(params, 3)
    assert sorted(port.state_dict()) == ["fc.bias", "fc.weight"]
    feats = np.random.default_rng(4).standard_normal((12, 512)).astype(np.float32)
    with torch.no_grad():
        got = port(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, np.asarray(clf.apply({"params": params}, feats)), atol=1e-6)
    back = classifier_state_dict_to_params(port.state_dict())
    for k in ("kernel", "bias"):
        np.testing.assert_array_equal(back["fc"][k], np.asarray(params["fc"][k]))


@pytest.fixture(scope="module")
def encoders():
    """A JAX rn10 (16 px) with running statistics moved off their init,
    and the port's copy of it."""
    model = JaxSupConResNet(model_name="resnet10")
    v = jax.jit(lambda k, x: model.init(k, x, train=False))(
        jax.random.key(11), jnp.zeros((2, 16, 16, 3)))
    rng = np.random.default_rng(12)
    stats = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.random(a.shape).astype(np.float32),
                         v["batch_stats"])
    variables = {"params": v["params"], "batch_stats": stats}
    port = SupConResNet("resnet10")
    port.load_state_dict(variables_to_state_dict(variables))
    port.eval().requires_grad_(False)
    return model, variables, port


@functools.partial(jax.jit, static_argnums=0)
def _jax_encode(model, variables, images):
    return model.apply(variables, images, train=False,
                       method=JaxSupConResNet.encode).astype(jnp.float32)


def jax_features(model, variables, images):
    return np.asarray(_jax_encode(model, variables, jnp.asarray(images)))


def test_three_probe_steps_match_jax(encoders):
    model, variables, port = encoders
    classes, n, steps = 3, 12, 3
    clf, params = jax_classifier(classes, 13)
    sched = dict(learning_rate=5.0, epochs=3, steps_per_epoch=1, lr_decay_rate=0.2,
                 lr_decay_epochs=(1, 2))
    tx = jax_optimizer(jax_schedule(**sched), momentum=0.9, weight_decay=1e-4)
    opt = tx.init(params)
    clf_port = port_classifier(params, classes)
    state = TrainState(model=clf_port, schedule=make_lr_schedule(**sched),
                       optimizer=make_optimizer(clf_port, momentum=0.9, weight_decay=1e-4))
    rng = np.random.default_rng(14)
    for step in range(steps):
        images = rng.standard_normal((n, 16, 16, 3)).astype(np.float32)
        labels = rng.integers(0, classes, n).astype(np.int32)
        want_f = jax_features(model, variables, images)
        got_f = linear.encode(port, torch.from_numpy(images)).numpy()
        np.testing.assert_allclose(got_f, want_f, atol=FEATURE_ATOL, err_msg=f"step {step}")

        def loss_fn(p):
            logits = clf.apply({"params": p}, want_f)
            return jlosses.cross_entropy_loss(logits, jnp.asarray(labels)), logits

        (loss, want_z), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        w = clf_port.fc.weight.detach().numpy()
        dw = np.abs(w - np.asarray(params["fc"]["kernel"]).T)
        db = np.abs(clf_port.fc.bias.detach().numpy() - np.asarray(params["fc"]["bias"]))
        with torch.no_grad():
            got_z = clf_port(torch.from_numpy(got_f)).numpy()
        w_norm = np.linalg.norm(w, axis=1)
        bound = (np.linalg.norm(got_f - want_f, axis=1)[:, None] * w_norm[None, :]
                 + np.linalg.norm(dw, axis=1)[None, :] * np.linalg.norm(want_f, axis=1)[:, None]
                 + db[None, :]
                 + ROUNDING * (np.abs(got_f) @ np.abs(w).T + np.abs(got_z)))
        assert np.all(np.abs(got_z - np.asarray(want_z)) <= bound), f"step {step}"

        metrics = linear.probe_step(port, state, torch.from_numpy(images),
                                    torch.from_numpy(labels).long())
        assert abs(metrics["loss"].item() - float(loss)) <= 2 * bound.max() + 1e-6 * float(loss)
        updates, opt = tx.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        np.testing.assert_allclose(clf_port.fc.weight.detach().numpy(),
                                   np.asarray(params["fc"]["kernel"]).T, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(clf_port.fc.bias.detach().numpy(),
                                   np.asarray(params["fc"]["bias"]), rtol=1e-5, atol=1e-5)
    assert state.step == steps


def test_validation_over_a_ragged_split_matches_jax(encoders):
    model, variables, port = encoders
    classes, n = 7, 12  # batches of 5, 5 and 2
    clf, params = jax_classifier(classes, 15)
    rng = np.random.default_rng(16)
    images = rng.integers(0, 256, (n, 16, 16, 3)).astype(np.uint8)
    labels = rng.integers(0, classes, n).astype(np.int32)
    cfg = AugmentConfig(size=16, mean=(0.5,) * 3, std=(0.25,) * 3, color_ops=False)
    got = linear.run_validation(port, port_classifier(params, classes), images, labels, 5, cfg,
                                torch.device("cpu"))
    x = np.asarray(jaug.eval_batch(jnp.asarray(images), cfg))
    logits = clf.apply({"params": params}, jax_features(model, variables, x))
    want_loss = float(jlosses.cross_entropy_loss(logits, jnp.asarray(labels)))
    top1, top5 = jmetrics.topk_accuracy(logits, jnp.asarray(labels), (1, 5))
    np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
    # the JAX percentages are fp32, the port's float64 over the same counts
    assert (got["top1"], got["top5"]) == pytest.approx((float(top1), float(top5)), rel=1e-6)


def tiny_dataset(dataset, data_folder):
    """64 train and 24 test images of 4 classes, 32 px (the probe's size)."""
    rng = np.random.default_rng(0)
    labels = rng.integers(0, 4, 88).astype(np.int32)
    means = rng.uniform(40, 216, (4, 1, 1, 3))
    images = np.clip(means[labels] + rng.normal(0, 16, (88, 32, 32, 3)), 0, 255)
    images = images.astype(np.uint8)
    return ({"images": images[:64], "labels": labels[:64]},
            {"images": images[64:], "labels": labels[64:]}, 4)


@pytest.fixture(scope="module")
def probed(tmp_path_factory):
    """A tiny port pretrain (rn10, 8 px crops), then the probe driver from
    its ``last.pth`` on ``--device cpu``."""
    workdir = tmp_path_factory.mktemp("probe")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(supcon, "load_dataset", tiny_dataset)
        mp.setattr(linear, "load_dataset", tiny_dataset)
        pre = supcon.main([
            "--device", "cpu", "--dataset", "synthetic", "--model", "resnet10", "--size", "8",
            "--batch_size", "16", "--epochs", "1", "--print_freq", "100",
            "--workdir", str(workdir),
        ])
        ckpt = os.path.join(pre.save_folder, "last.pth")
        result = linear.main([
            "--device", "cpu", "--dataset", "synthetic", "--model", "resnet10",
            "--batch_size", "16", "--epochs", "1", "--learning_rate", "1",
            "--val_batch_size", "10", "--print_freq", "2", "--workdir", str(workdir),
            "--ckpt", ckpt, "--resume", pre.save_folder,
        ])
    return ckpt, result


def test_probe_driver_end_to_end_on_cpu(probed):
    ckpt, result = probed
    assert len(result.history) == 4 and len(result.val_history) == 1
    assert 0.0 < result.best_acc <= 100.0 and result.best_acc <= result.best_acc5 <= 100.0
    log = open(os.path.join(result.save_folder, "log-ing")).read()
    assert f"loaded encoder from {ckpt}" in log
    assert "the probe keeps no full-state checkpoints; retraining from scratch" in log
    assert "Train: [1][2/4]\tBT " in log and " * Acc@1 " in log
    assert f"best accuracy: {result.best_acc:.2f}, accuracy5: {result.best_acc5:.2f}" in log
    assert os.path.basename(result.save_folder).startswith("classifier_")
    reloaded = LinearClassifier("resnet10", 4)
    reloaded.load_state_dict(load_classifier(result.classifier_path))
    feats = torch.randn(6, 512)
    with torch.no_grad():
        assert torch.equal(reloaded(feats), result.state.model(feats))


def test_probe_leaves_the_encoder_bitwise_unchanged(probed):
    ckpt, result = probed
    want = load_model_state(ckpt)
    got = result.model.state_dict()
    for k, v in got.items():
        if k.startswith("encoder."):
            assert torch.equal(v, want[k]), k
    assert not result.model.training
    assert not any(p.requires_grad or p.grad is not None for p in result.model.parameters())


def test_probe_config_defaults_and_folder():
    cfg = config_lib.parse_linear(["--dataset", "synthetic_hard32", "--workdir", "w"])
    assert (cfg.batch_size, cfg.learning_rate, cfg.epochs, cfg.lr_decay_epochs,
            cfg.lr_decay_rate, cfg.weight_decay, cfg.momentum, cfg.val_batch_size) == (
        512, 0.1, 100, (60, 75, 90), 0.2, 0.0, 0.9, 256)
    assert cfg.n_cls == 32 and cfg.device == "cuda"
    assert os.path.basename(cfg.save_folder).startswith("classifier_")
    assert cfg.save_folder.endswith("_synthetic_hard32_resnet50_lr_0.1_decay_0.0_bsz_512")


def test_probe_default_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        linear.main(["--dataset", "synthetic", "--model", "resnet10", "--workdir", str(tmp_path)])


def rn18_state(seed):
    torch.manual_seed(seed)
    model = SupConResNet("resnet18")
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.add_(0.1 * torch.rand(buf.shape))
    return model.eval()


def port_features(model, x):
    with torch.no_grad():
        return model.encode(torch.from_numpy(x)).numpy()


def test_port_pth_loads_into_jax_with_the_same_features(tmp_path):
    port = rn18_state(21)
    path = tmp_path / "last.pth"
    torch.save({"model": {f"module.{k}": v for k, v in port.state_dict().items()},
                "epoch": 1}, path)
    abstract = jax.eval_shape(lambda: JaxSupConResNet(model_name="resnet18").init(
        jax.random.key(0), jnp.zeros((2, 16, 16, 3)), train=False))
    variables = load_pretrained_variables(str(path), {"params": abstract["params"],
                                                      "batch_stats": abstract["batch_stats"]})
    x = np.random.default_rng(22).standard_normal((8, 16, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(port_features(port, x),
                               jax_features(JaxSupConResNet(model_name="resnet18"), variables, x),
                               atol=FEATURE_ATOL)


def test_jax_exported_pth_loads_into_the_port(tmp_path):
    model = JaxSupConResNet(model_name="resnet18")
    v = model.init(jax.random.key(23), jnp.zeros((2, 16, 16, 3)), train=False)
    variables = {"params": v["params"], "batch_stats": v["batch_stats"]}
    _save_tree(str(tmp_path / "ckpt" / "model"), variables)
    _write_meta(str(tmp_path / "ckpt"), {"epoch": 4, "model_layout": MODEL_LAYOUT_VERSION})
    pth = tmp_path / "exported.pth"
    export_reference_checkpoint(str(tmp_path / "ckpt"), str(pth))
    port = SupConResNet("resnet18")
    port.load_state_dict(load_model_state(str(pth)))  # weights_only=True
    x = np.random.default_rng(24).standard_normal((8, 16, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(port_features(port.eval(), x), jax_features(model, variables, x),
                               atol=FEATURE_ATOL)


def test_port_to_jax_to_port_is_bitwise(tmp_path):
    sd = rn18_state(25).state_dict()
    src = tmp_path / "port.pth"
    torch.save({"model": {f"module.{k}": v for k, v in sd.items()}, "epoch": 2}, src)
    convert_reference_checkpoint(str(src), str(tmp_path / "jax"))
    export_reference_checkpoint(str(tmp_path / "jax"), str(tmp_path / "back.pth"))
    back = load_model_state(str(tmp_path / "back.pth"))
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k  # num_batches_tracked: 0 both ways
    # and the in-memory bridge
    again = variables_to_state_dict(state_dict_to_variables(sd))
    for k, v in sd.items():
        assert torch.equal(again[k], v), k
