from hint_tpu_torch.data.fourier import FourierCurveModel, LensShapeModel, PlusShapeModel
from hint_tpu_torch.data.loaders import prepare_toy_data, prepare_uci_data, to_device
from hint_tpu_torch.data.uci import Gas, Miniboone, Power

__all__ = [
    "FourierCurveModel",
    "LensShapeModel",
    "PlusShapeModel",
    "Power",
    "Gas",
    "Miniboone",
    "prepare_toy_data",
    "prepare_uci_data",
    "to_device",
]
