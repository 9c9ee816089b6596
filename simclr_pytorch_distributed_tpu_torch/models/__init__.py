from simclr_pytorch_distributed_tpu_torch.models.heads import SupConResNet, projection_head
from simclr_pytorch_distributed_tpu_torch.models.resnet import MODEL_DICT, ResNet

__all__ = ["MODEL_DICT", "ResNet", "SupConResNet", "projection_head"]
