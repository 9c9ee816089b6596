"""Data parallelism over ``torch.distributed``: the process group
(``mesh.py``) and the collectives of the train step (``collectives.py``)."""
