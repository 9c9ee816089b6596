"""KNOWN-BAD: a model-group collective behind the grid's model index.

Under ``--model_parallel`` the ranks of a model group trade channel slices;
a gather that only model index 0 enters leaves its peers waiting in the
gather forever. The data-group mean below runs on every rank and is fine.
"""

from simclr_pytorch_distributed_tpu_torch.parallel import collectives, mesh


def gather_on_first_shard(x, params):
    if mesh.model_index() == 0:
        x = collectives.gather_channels(x, mesh.model_group(), partial=True)
    collectives.mean_gradients(params, mesh.data_group())
    return x
