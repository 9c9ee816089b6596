"""The port's serving engine (``serve/engine.py``) against the JAX package's,
on the CPU at rn10, 8 px.

One set of weights: the port's seeded rn10 with its BN affine parameters
and running statistics perturbed by seeded numpy draws (as
``test_torch_port_models.py``), moved to the JAX engine through the port's
``utils/convert.py``. The same numpy-seeded uint8 images go through
``EmbeddingEngine.embed`` of both packages at bucket 8:

- features and projections, L2-normalized and not: within the port's
  eval-mode pin, 2e-4 times the largest reference magnitude;
- ``dtype='bf16'`` against the JAX engine's bf16: lowest cosine > 0.995.

Then the JAX engine's contract tests, one for one, on the port engine
(``tests/test_serve_engine.py``, except ``test_bucket_sharding_policy``:
the port serves on one device and scales out through the replica fleet),
and the eval-mode determinism tests of ``tests/test_eval_determinism.py``
on the port model. ``infer_architecture`` is held against JAX's
``infer_architecture_from_variables`` on every ``MODEL_DICT`` name and both
heads, and ``from_checkpoint`` reads a port trainer's ``.pth``, its run
folder, and a reference-layout ``.pth`` (the JAX package's export), with
the mean/std and the image size of the checkpoint's ``opt``.
"""

import os

import numpy as np
import pytest
import torch
from torch import nn

from simclr_pytorch_distributed_tpu.models import SupConResNet as JaxSupConResNet
from simclr_pytorch_distributed_tpu.models import infer_architecture_from_variables
from simclr_pytorch_distributed_tpu.serve.engine import EmbeddingEngine as JaxEngine
from simclr_pytorch_distributed_tpu_torch.models import MODEL_DICT, SupConResNet
from simclr_pytorch_distributed_tpu_torch.models import infer_architecture
from simclr_pytorch_distributed_tpu_torch.ops.augment import DATASET_STATS
from simclr_pytorch_distributed_tpu_torch.serve.cache import EmbeddingCache
from simclr_pytorch_distributed_tpu_torch.serve.engine import EmbeddingEngine
from simclr_pytorch_distributed_tpu_torch.utils.convert import state_dict_to_variables
from torch_threads import limit_threads

limit_threads()

SIZE = 8
EVAL_PIN = 2e-4  # x max|ref|: the port's eval-mode pin (test_torch_port_models.py)
BF16_COS = 0.995


def images_of(rng, n):
    return rng.integers(0, 256, size=(n, SIZE, SIZE, 3), dtype=np.uint8)


def perturbed_state_dict(model_name="resnet10", head="mlp", feat_dim=128, seed=0):
    torch.manual_seed(seed)
    model = SupConResNet(model_name, head, feat_dim)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
    return model.state_dict()


@pytest.fixture(scope="module")
def weights():
    sd = perturbed_state_dict()
    return sd, state_dict_to_variables(sd)


def port_engine(state_dict, **kwargs):
    kwargs.setdefault("buckets", (2, 8))
    kwargs.setdefault("img_size", SIZE)
    return EmbeddingEngine(SupConResNet("resnet10"), state_dict, device="cpu", **kwargs)


@pytest.fixture(scope="module")
def engine(weights):
    return port_engine(weights[0])


# ------------------------------------------------------- against the JAX engine


@pytest.mark.parametrize("output", ["features", "projection"])
@pytest.mark.parametrize("normalize", [False, True])
def test_embed_matches_the_jax_engine(weights, output, normalize):
    sd, variables = weights
    x = images_of(np.random.default_rng(20), 8)
    ref = JaxEngine(JaxSupConResNet(model_name="resnet10"), variables, buckets=(8,),
                    img_size=SIZE, output=output, normalize=normalize).embed(x)
    got = port_engine(sd, buckets=(8,), output=output, normalize=normalize).embed(x)
    assert got.shape == ref.shape == (8, 512 if output == "features" else 128)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=EVAL_PIN * np.abs(ref).max())


@pytest.mark.parametrize("output", ["features", "projection"])
def test_bf16_embed_matches_the_jax_bf16_engine(weights, output):
    sd, variables = weights
    x = images_of(np.random.default_rng(21), 8)
    ref = JaxEngine(JaxSupConResNet(model_name="resnet10"), variables, buckets=(8,),
                    img_size=SIZE, output=output, dtype="bf16").embed(x)
    got = port_engine(sd, buckets=(8,), output=output, dtype="bf16").embed(x)
    assert got.dtype == np.float32
    cos = (got * ref).sum(1) / (np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1))
    assert cos.min() > BF16_COS


# --------------------------------------- the JAX engine's contract, on the port


def test_no_recompile_within_a_bucket(engine):
    """Sizes 3..8 share bucket 8: one first forward there, and only the two
    buckets ever count one (the counterpart of the JAX compile count)."""
    rng = np.random.default_rng(0)
    for n in (3, 5, 7, 8, 4, 6):
        out = engine.embed(images_of(rng, n))
        assert out.shape == (n, 512) and out.dtype == np.float32
    assert engine.stats()["traces"].get(8) == 1
    engine.embed(images_of(rng, 1))
    engine.embed(images_of(rng, 2))
    assert engine.stats()["traces"].get(2) == 1
    assert sum(engine.stats()["traces"].values()) == 2


def test_padded_bucket_equals_exact_batch(engine):
    rng = np.random.default_rng(1)
    x5 = images_of(rng, 5)
    peers = images_of(rng, 3)
    a = engine.embed(x5)
    b = engine.embed(np.concatenate([x5, peers]))
    np.testing.assert_array_equal(a, b[:5])


def test_cross_bucket_agreement_is_float_tight(engine):
    rng = np.random.default_rng(2)
    x2 = images_of(rng, 2)
    a = engine.embed(x2)
    b = engine.embed(np.concatenate([x2, images_of(rng, 6)]))
    np.testing.assert_allclose(a, b[:2], rtol=1e-5, atol=1e-5)


def test_repeat_call_bit_stable(engine):
    x = images_of(np.random.default_rng(3), 4)
    np.testing.assert_array_equal(engine.embed(x), engine.embed(x))


def test_requests_above_top_bucket_are_chunked(engine):
    x = images_of(np.random.default_rng(4), 13)
    before = dict(engine.stats()["bucket_dispatches"])
    out = engine.embed(x)
    after = engine.stats()["bucket_dispatches"]
    assert out.shape == (13, 512)
    assert after[8] - before[8] == 2
    np.testing.assert_array_equal(out[:8], engine.embed(x[:8]))
    np.testing.assert_array_equal(out[8:], engine.embed(x[8:]))
    assert set(engine.stats()["traces"].values()) == {1}


def test_empty_request_and_validation(engine):
    assert engine.embed(np.zeros((0, SIZE, SIZE, 3), np.uint8)).shape == (0, 512)
    with pytest.raises(ValueError, match="expected"):
        engine.embed(np.zeros((2, SIZE, SIZE), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        engine.embed(np.zeros((2, SIZE, SIZE, 3), np.float32))


def test_unpinned_geometry_is_rejected_not_run(engine):
    before = dict(engine.stats()["bucket_dispatches"])
    with pytest.raises(ValueError, match="pinned at construction"):
        engine.embed(np.zeros((2, SIZE * 2, SIZE * 2, 3), np.uint8))
    with pytest.raises(ValueError, match="pinned"):
        engine.validate_images(np.zeros((1, SIZE, SIZE + 1, 3), np.uint8))
    assert engine.stats()["bucket_dispatches"] == before


def test_bucket_for(engine):
    assert [engine.bucket_for(n) for n in (1, 2, 3, 8, 9)] == [2, 2, 8, 8, 8]


def test_dispatch_defers_materialization_and_dispatches_all_chunks(engine):
    x = images_of(np.random.default_rng(8), 13)
    before = dict(engine.stats()["bucket_dispatches"])
    h = engine.dispatch(x)
    assert engine.stats()["bucket_dispatches"][8] - before[8] == 2
    assert not h.done()
    assert h.n_rows == 13
    out = h.result()
    assert h.done() and out.shape == (13, 512)
    np.testing.assert_array_equal(out, engine.embed(x))
    assert h.result() is out


def test_dispatch_populates_cache_at_completion(weights):
    eng = port_engine(weights[0], buckets=(2,), cache=EmbeddingCache(capacity=64))
    x = images_of(np.random.default_rng(9), 2)
    h = eng.dispatch(x)
    assert len(eng.cache) == 0
    first = h.result()
    assert len(eng.cache) == 2
    dispatches = sum(eng.stats()["bucket_dispatches"].values())
    second = eng.dispatch(x).result()
    assert sum(eng.stats()["bucket_dispatches"].values()) == dispatches
    np.testing.assert_array_equal(first, second)


def test_bf16_serving_parity_and_contract(engine, weights):
    """bf16 computes the encoder in bf16 with fp32 parameters and BN
    statistics, returns fp32, within the JAX engine's pin of fp32."""
    b16 = port_engine(weights[0], buckets=(8,), dtype="bf16")
    x = images_of(np.random.default_rng(10), 8)
    a = engine.embed(x)
    b = b16.embed(x)
    assert b.dtype == np.float32
    np.testing.assert_allclose(b, a, rtol=0.05, atol=0.05)
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    assert cos.min() > BF16_COS
    assert b16.stats()["dtype"] == "bf16"
    assert b16.model.encoder.compute_dtype == torch.bfloat16
    assert {t.dtype for t in b16.model.state_dict().values()} <= {torch.float32, torch.int64}
    assert b16._key_prefix != engine._key_prefix
    with pytest.raises(ValueError, match="dtype"):
        EmbeddingEngine.random_init(model_name="resnet10", size=SIZE, dtype="fp16",
                                    device="cpu")


def test_normalized_output_is_unit_norm(weights):
    eng = port_engine(weights[0], buckets=(2,), normalize=True)
    out = eng.embed(images_of(np.random.default_rng(5), 2))
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, rtol=1e-5)


def test_cache_hits_skip_engine_execution(weights):
    eng = port_engine(weights[0], buckets=(2,), cache=EmbeddingCache(capacity=64))
    rng = np.random.default_rng(6)
    x = images_of(rng, 2)
    first = eng.embed(x)
    dispatches = sum(eng.stats()["bucket_dispatches"].values())
    second = eng.embed(x)
    assert sum(eng.stats()["bucket_dispatches"].values()) == dispatches
    assert eng.stats()["cache_hit_rows"] == 2
    np.testing.assert_array_equal(first, second)
    y = np.stack([x[0], images_of(rng, 1)[0]])
    mixed = eng.embed(y)
    assert sum(eng.stats()["bucket_dispatches"].values()) == dispatches + 1
    np.testing.assert_array_equal(mixed[0], first[0])
    assert eng.stats()["cache"]["hits"] == 3


def test_shared_cache_never_crosses_engines():
    shared = EmbeddingCache(capacity=64)
    a = EmbeddingEngine.random_init(model_name="resnet10", size=SIZE, seed=0, buckets=(2,),
                                    cache=shared, device="cpu")
    b = EmbeddingEngine.random_init(model_name="resnet10", size=SIZE, seed=1, buckets=(2,),
                                    cache=shared, device="cpu")
    x = images_of(np.random.default_rng(7), 2)
    out_a = a.embed(x)
    out_b = b.embed(x)
    assert shared.stats()["hits"] == 0
    assert not np.allclose(out_a, out_b)
    np.testing.assert_array_equal(b.embed(x), out_b)
    assert shared.stats()["hits"] == 2


def test_random_init_is_seeded_and_leaves_the_global_generator():
    state = torch.random.get_rng_state()
    a = EmbeddingEngine.random_init(model_name="resnet10", size=SIZE, seed=3, device="cpu")
    b = EmbeddingEngine.random_init(model_name="resnet10", size=SIZE, seed=3, device="cpu")
    assert a._weights_probe == b._weights_probe
    assert torch.equal(torch.random.get_rng_state(), state)


def test_the_card_is_the_default_and_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default engine would run there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EmbeddingEngine.random_init(model_name="resnet10", size=SIZE)


# ------------------------------------- eval-mode determinism, on the port model


@pytest.fixture(scope="module")
def eval_model(weights):
    model = SupConResNet("resnet10")
    model.load_state_dict(weights[0])
    return model.eval().requires_grad_(False)


def _inputs(rng, n):
    return torch.from_numpy(rng.standard_normal((n, SIZE, SIZE, 3)).astype(np.float32))


def test_repeat_calls_bit_identical(eval_model):
    x = _inputs(np.random.default_rng(0), 4)
    with torch.inference_mode():
        np.testing.assert_array_equal(eval_model.encode(x).numpy(), eval_model.encode(x).numpy())


def test_rows_independent_of_pad_content(eval_model):
    rng = np.random.default_rng(1)
    x5 = _inputs(rng, 5)
    garbage = _inputs(rng, 3) * 100.0
    with torch.inference_mode():
        a = eval_model.encode(torch.cat([x5, torch.zeros(3, SIZE, SIZE, 3)]))[:5]
        b = eval_model.encode(torch.cat([x5, garbage]))[:5]
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_across_batch_sizes_float_tight(eval_model):
    x5 = _inputs(np.random.default_rng(2), 5)
    with torch.inference_mode():
        a = eval_model.encode(x5)
        b = eval_model.encode(torch.cat([x5, torch.zeros(27, SIZE, SIZE, 3)]))[:5]
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_eval_mode_does_not_touch_bn_buffers(weights):
    eng = port_engine(weights[0], buckets=(8,))
    eng.embed(images_of(np.random.default_rng(3), 8))
    after = eng.model.state_dict()
    for k, v in weights[0].items():
        assert torch.equal(after[k], v), k


# ------------------------------------------------- architecture and checkpoints


@pytest.mark.parametrize("model_name", sorted(MODEL_DICT))
def test_infer_architecture_matches_jax(model_name):
    for head, feat_dim in (("mlp", 64), ("linear", 32)):
        torch.manual_seed(0)
        sd = SupConResNet(model_name, head, feat_dim).state_dict()
        got = infer_architecture(sd)
        assert got == infer_architecture_from_variables(state_dict_to_variables(sd))
        assert got == (model_name, head, feat_dim)


def test_infer_architecture_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="encoder"):
        infer_architecture_from_variables({"params": {"whatever": {}}})
    with pytest.raises(ValueError, match="encoder"):
        infer_architecture({"whatever.weight": torch.zeros(1)})
    sd = SupConResNet("resnet10").state_dict()
    with pytest.raises(ValueError, match="encoder"):
        infer_architecture({k: v for k, v in sd.items() if not k.startswith("head.")})
    odd = dict(sd, **{"encoder.layer2.5.conv1.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="geometry"):
        infer_architecture(odd)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny port pretrain (rn10, 8 px, ``--dataset cifar100`` on 64
    generated images): its run folder and ``last.pth``."""
    from simclr_pytorch_distributed_tpu_torch.train import supcon

    def tiny(dataset, data_folder):
        rng = np.random.default_rng(0)
        images = rng.integers(0, 256, (64, 32, 32, 3), dtype=np.uint8)
        labels = rng.integers(0, 4, 64).astype(np.int32)
        return {"images": images, "labels": labels}, {"images": images, "labels": labels}, 4

    workdir = tmp_path_factory.mktemp("serve_pretrain")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(supcon, "load_dataset", tiny)
        result = supcon.main([
            "--device", "cpu", "--dataset", "cifar100", "--no_download", "--model",
            "resnet10", "--size", "8", "--batch_size", "16", "--epochs", "1",
            "--print_freq", "100", "--workdir", str(workdir),
        ])
    return result.save_folder, os.path.join(result.save_folder, "last.pth")


def test_from_checkpoint_reads_a_port_pth_and_its_run_folder(trained):
    folder, last = trained
    from simclr_pytorch_distributed_tpu_torch.utils.checkpoint import load_model_state

    for path in (last, folder):
        eng = EmbeddingEngine.from_checkpoint(path, buckets=(2,), device="cpu")
        assert (eng.model_name, eng.feat_dim, eng.img_size) == ("resnet10", 512, 8)
        assert eng._aug_cfg.mean == DATASET_STATS["cifar100"][0]
        assert eng._aug_cfg.std == DATASET_STATS["cifar100"][1]
        want = load_model_state(last)
        got = eng.model.state_dict()
        assert all(torch.equal(got[k], v) for k, v in want.items())
    eng = EmbeddingEngine.from_checkpoint(last, buckets=(2,), device="cpu",
                                          std=(1.0, 1.0, 1.0), img_size=16)
    assert eng._aug_cfg.std == (1.0, 1.0, 1.0) and eng.img_size == 16


def test_from_checkpoint_reads_a_reference_layout_pth(tmp_path, weights):
    """The layout of the JAX package's ``torch_convert --export``: the
    ``'module.'``-prefixed state dict, its ``opt`` naming the architecture
    with the run's config nested under ``config``."""
    sd, variables = weights
    path = tmp_path / "exported.pth"
    torch.save({"opt": {"model": "resnet10", "head": "mlp", "feat_dim": 128,
                        "config": {"dataset": "cifar100", "size": SIZE}},
                "model": {f"module.{k}": v for k, v in sd.items()},
                "optimizer": {}, "epoch": 3}, path)
    eng = EmbeddingEngine.from_checkpoint(str(path), buckets=(8,), device="cpu")
    assert (eng.model_name, eng.img_size) == ("resnet10", SIZE)
    assert eng._aug_cfg.mean == DATASET_STATS["cifar100"][0]
    x = images_of(np.random.default_rng(22), 8)
    ref = JaxEngine(JaxSupConResNet(model_name="resnet10"), variables, buckets=(8,),
                    img_size=SIZE, mean=DATASET_STATS["cifar100"][0],
                    std=DATASET_STATS["cifar100"][1]).embed(x)
    np.testing.assert_allclose(eng.embed(x), ref, rtol=0, atol=EVAL_PIN * np.abs(ref).max())
    with pytest.raises(FileNotFoundError):
        EmbeddingEngine.from_checkpoint(str(tmp_path / "missing.pth"), device="cpu")
