from stark_tpu_torch.utils.xgcd import xgcd

__all__ = ["xgcd"]
