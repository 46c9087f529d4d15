from split_learning_tpu_torch.models.cnn import (
    CNNHeadC, CNNPartA, CNNPartB, CNNTrunkB, chain3_cnn_plan, split_cnn_plan,
    u_split_cnn_plan)
from split_learning_tpu_torch.models.factory import get_model, get_plan
from split_learning_tpu_torch.models.resnet import resnet18_plan
from split_learning_tpu_torch.models.transformer import transformer_plan
from split_learning_tpu_torch.models.vit import vit_plan

__all__ = ["CNNHeadC", "CNNPartA", "CNNPartB", "CNNTrunkB",
           "chain3_cnn_plan", "get_model", "get_plan", "resnet18_plan",
           "split_cnn_plan", "transformer_plan", "u_split_cnn_plan",
           "vit_plan"]
