"""Device time in kernels that are neither GEMM, attention nor convolution
(``kernel_classes.json``), in microseconds per frame the tower encoded."""


def read(r):
    encoded = r.counters.get("encoded_frames")
    return r.device_s("elementwise") * 1e6 / encoded if encoded else None
