"""The port's pretraining entry point end to end on the CPU.

``train.supcon.main`` runs one epoch of rn10 at 8 px with the fused loss
(on CPU tensors its plain forms), writes the reference ``log-ing`` lines
and a ``last.pth`` in the reference ``.pth`` layout. The JAX package reads
that file (the reference layout's four keys beside the resume state),
both through ``torch_state_dict_to_variables`` and through
``convert_reference_checkpoint``, and its eval forward of the tree matches
the port's (rtol 1e-3 / atol 1e-4). Without ``--device cpu`` on a host with
no CUDA, ``main`` raises.
"""

import math
import os

import numpy as np
import pytest
import torch

from simclr_pytorch_distributed_tpu.models import SupConResNet as JaxSupConResNet
from simclr_pytorch_distributed_tpu.utils.torch_convert import (
    convert_reference_checkpoint,
    torch_state_dict_to_variables,
)
from simclr_pytorch_distributed_tpu_torch.train import supcon
from torch_threads import limit_threads

limit_threads()

ARGV = [
    "--device", "cpu", "--dataset", "synthetic", "--model", "resnet10",
    "--size", "8", "--batch_size", "16", "--epochs", "1", "--loss_impl", "fused",
    "--method", "SimCLR", "--temp", "0.5", "--learning_rate", "0.5", "--cosine",
    "--print_freq", "50", "--save_freq", "1", "--feat_dim", "32",
]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("port_driver")
    return supcon.main(ARGV + ["--workdir", str(workdir)])


def test_runs_an_epoch_and_logs_like_the_reference(run):
    assert len(run.history) == 112  # 1792 synthetic images / 16
    assert all(math.isfinite(h["loss"]) for h in run.history)
    assert [h["step"] for h in run.history] == list(range(112))
    log = open(os.path.join(run.save_folder, "log-ing")).read()
    assert "[loss_impl] 'fused': explicit request" in log
    assert "Train: [1][50/112]\tBT " in log and "Train: [1][112/112]" in log
    assert "epoch 1, total time" in log
    assert os.path.isfile(os.path.join(run.save_folder, "ckpt_epoch_1.pth"))


def test_last_checkpoint_loads_into_the_jax_package(run, tmp_path):
    path = os.path.join(run.save_folder, "last.pth")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    # the reference layout's four keys, and the full state a resume needs
    assert sorted(ckpt) == ["epoch", "generator", "generator_device", "lr_scale", "model",
                            "opt", "optimizer", "record_norm_mean", "rollbacks", "seed", "step",
                            "step_in_epoch", "world_size"]
    assert (ckpt["world_size"], ckpt["lr_scale"], ckpt["rollbacks"]) == (1, 1.0, 0)
    assert ckpt["epoch"] == 1 and ckpt["opt"]["model"] == "resnet10"
    assert all(k.startswith("module.") for k in ckpt["model"])

    variables = torch_state_dict_to_variables(ckpt["model"])
    x = np.random.default_rng(0).standard_normal((4, 8, 8, 3)).astype(np.float32)
    jax_out = JaxSupConResNet(model_name="resnet10", head="mlp", feat_dim=32).apply(
        variables, x, train=False
    )
    model = run.state.model.eval()
    with torch.no_grad():
        port_out = model(torch.from_numpy(x))
    np.testing.assert_allclose(port_out.numpy(), np.asarray(jax_out), rtol=1e-3, atol=1e-4)

    info = convert_reference_checkpoint(path, str(tmp_path / "converted"))
    assert (info["model_name"], info["head"], info["feat_dim"], info["epoch"]) == (
        "resnet10", "mlp", 32, 1,
    )


def test_cuda_default_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    argv = [a for a in ARGV if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        supcon.main(argv + ["--workdir", str(tmp_path)])
    assert not any(tmp_path.rglob("log-ing"))


@pytest.mark.parametrize("flag", [["--compile_cache", "auto"], ["--model_parallel", "0"]])
def test_unimplemented_flags_are_rejected(tmp_path, flag):
    # a JAX flag the port does not take, and a model-parallel size below 1:
    # argparse refuses them before any run (--model_parallel N >= 1 is
    # ported; tests/test_torch_port_tensor_parallel.py holds it)
    with pytest.raises(SystemExit):
        supcon.main(ARGV + ["--workdir", str(tmp_path)] + flag)
    assert not any(tmp_path.rglob("log-ing"))
