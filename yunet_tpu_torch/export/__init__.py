from ..models.fused import fold_conv_bn
from .cpp_export import generate_cpp
from .onnx_export import export_onnx
from .onnx_reader import read_onnx

__all__ = ["generate_cpp", "fold_conv_bn", "export_onnx", "read_onnx"]
