from .rowwise import rowwise_matmul, rowwise_matmul_plain  # noqa: F401
