"""CLI: ``python -m simclr_pytorch_distributed_tpu_torch.serve.fleet [flags]`` —
the multi-model frontend (serve/fleet/frontend.py). The replica-fleet
supervisor spawns exactly this as its replica process."""

from simclr_pytorch_distributed_tpu_torch.serve.fleet.frontend import main

if __name__ == "__main__":
    main()
