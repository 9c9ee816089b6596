"""The port's weight bridge (``utils/convert.py``) against the JAX package's.

A JAX ``{'params', 'batch_stats'}`` tree of the JAX model's own structure
(from ``eval_shape``, filled with seeded numpy values) must map to the same
state dict through both packages, key for key and bit for bit, and the
port's inverse must give the tree back exactly. The mapped state dict must
also load strictly into the port's ``SupConResNet``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from simclr_pytorch_distributed_tpu.models import SupConResNet as JaxSupConResNet
from simclr_pytorch_distributed_tpu.utils.torch_convert import (
    variables_to_torch_state_dict,
)
from simclr_pytorch_distributed_tpu_torch.models import SupConResNet
from simclr_pytorch_distributed_tpu_torch.utils.convert import (
    state_dict_to_variables,
    variables_to_state_dict,
)
from torch_threads import limit_threads

limit_threads()


def _filled_tree(model_name, head, seed):
    model = JaxSupConResNet(model_name=model_name, head=head, feat_dim=32)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.key(0), jnp.zeros((2, 8, 8, 3)), train=False)
    )
    rng = np.random.default_rng(seed)
    filled = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes
    )
    return {"params": filled["params"], "batch_stats": filled["batch_stats"]}


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("model_name", ["resnet10", "resnet18", "resnet50"])
@pytest.mark.parametrize("head", ["mlp", "linear"])
def test_state_dict_matches_jax_bridge_bitwise(model_name, head):
    tree = _filled_tree(model_name, head, seed=len(model_name))
    ours = variables_to_state_dict(tree)
    theirs = variables_to_torch_state_dict(tree)
    assert sorted(ours) == sorted(theirs)
    for key, ref in theirs.items():
        got = ours[key].numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape, key
        np.testing.assert_array_equal(got, ref, err_msg=key)

    port = SupConResNet(model_name, head, feat_dim=32)
    port.load_state_dict(ours, strict=True)


@pytest.mark.parametrize("model_name", ["resnet10", "resnet50"])
@pytest.mark.parametrize("head", ["mlp", "linear"])
def test_round_trip_is_identity(model_name, head):
    tree = _filled_tree(model_name, head, seed=3)
    back = state_dict_to_variables(variables_to_state_dict(tree))
    orig, rt = dict(_leaves(tree)), dict(_leaves(back))
    assert orig.keys() == rt.keys()
    for path, leaf in orig.items():
        np.testing.assert_array_equal(leaf, rt[path], err_msg="/".join(path))


def test_port_state_dict_round_trips_through_variables():
    port = SupConResNet("resnet18", "mlp", feat_dim=16)
    sd = port.state_dict()
    back = variables_to_state_dict(state_dict_to_variables(sd))
    assert sorted(back) == sorted(sd)
    for key, value in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        np.testing.assert_array_equal(back[key].numpy(), value.numpy(), err_msg=key)


def test_unmapped_key_raises():
    sd = SupConResNet("resnet10", "linear", feat_dim=8).state_dict()
    sd["encoder.extra.weight"] = sd["head.weight"]
    with pytest.raises(ValueError, match="unmapped"):
        state_dict_to_variables(sd)
