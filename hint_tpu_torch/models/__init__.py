from hint_tpu_torch.models.flow import Flow

__all__ = ["Flow"]
