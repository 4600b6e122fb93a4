"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
its 700 W limit). The f32 ceiling is TF32's tensor-core rate: no route that
keeps f32 accuracy can exceed it, where a correct 3xTF32 route could exceed
the 67 TFLOP/s of the CUDA cores."""

H100 = {
    "flops_f32": 495e12,
    "bytes_per_s": 3.35e12,
    "memory_bytes": 80e9,
}
