from simclr_pytorch_distributed_tpu_torch.models.heads import (
    LinearClassifier,
    PredictorHead,
    SupCEResNet,
    SupConResNet,
    infer_architecture,
    projection_head,
)
from simclr_pytorch_distributed_tpu_torch.models.resnet import MODEL_DICT, ResNet

__all__ = ["MODEL_DICT", "LinearClassifier", "PredictorHead", "ResNet", "SupCEResNet",
           "SupConResNet", "infer_architecture", "projection_head"]
