"""The names by which the device trace shows the program's hand-written
kernels and its collectives (a kernel's name as ``trace.short_name``
gives it)."""

# K1 ``moments`` (csrc/moments.cu): its four launches a call, as the
# port's bench names them (wcgan_tpu_torch/bench.py::K1_KERNELS).
K1 = ("col_partial_sums", "finalize_mean", "centered_gram_tf32x3",
      "reduce_gram")
# K3 ``mm_bf16x3`` (csrc/mm_bf16x3.cu): the row path and the C x C path.
K3_PREFIX = "mm_bf16x3"
NCCL_PREFIX = "nccl"


def is_k1(name: str) -> bool:
  return any(k in name for k in K1)


def is_k3(name: str) -> bool:
  return name.startswith(K3_PREFIX)


def is_nccl(name: str) -> bool:
  return name.lower().startswith(NCCL_PREFIX)
