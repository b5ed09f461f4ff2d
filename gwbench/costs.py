"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes each kernel of the GW scoring path and the whole model need.

Frozen here so that a change to the program cannot move it.  The counting
rules are those of the program's ``autotune.model.stack_kernel_costs`` and
of the row-wise bound its smoke script used (``H100_SXM``: 67 TFLOP/s of
fp32 on the CUDA cores, 3.35 TB/s of HBM3), applied to the model's own
layer widths rather than to a pack padded to one width: a roofline share
counts what the inputs need, not what one layout of them costs.
"""

from __future__ import annotations

from gwbench.references.lstm_autoencoder import layer_dims

#: NVIDIA H100 SXM data sheet (700 W): fp32 outside the tensor cores, and HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

FP32 = 4


def bound_s(cost: dict) -> float:
    """Least time the card needs for ``cost`` (``flops``, ``bytes``): the
    larger of operations over the fp32 peak and bytes over the memory
    rate."""
    return max(cost["flops"] / PEAK_FP32_FLOPS, cost["bytes"] / PEAK_BYTES_PER_S)


def segments(config: dict) -> tuple[list, list]:
    """(encoder layers, decoder layers) as ``layer_dims`` pairs."""
    dims = layer_dims(config)
    return dims[: config["latent_boundary"]], dims[config["latent_boundary"]:]


def stack_costs(dims: list[tuple[int, int]], batch: int, t_len: int) -> dict:
    """Operations and bytes of one wavefront launch (K1) over the layers
    ``dims`` (fp32 weights and state): layer 0's gate stream comes in, so
    its input product is not counted here.  Bytes: the (T, B, 4 h0) gate
    stream in, each layer's ``w_x``, ``w_h`` and bias, the state (h and c)
    read and written, the last layer's hidden sequence out.  Operations: 2
    per multiply-add of the gate products, 4 per gate pre-activation
    element and 10 per cell element.  At one width for every layer this is
    ``stack_kernel_costs(L, W, B, T, step=False)``."""
    h0 = dims[0][1]
    weights = sum((i * 4 * h + h * 4 * h + 4 * h) * FP32 for i, h in dims)
    state = sum(2 * batch * h * 2 * FP32 for _, h in dims)
    n_bytes = t_len * batch * 4 * h0 * FP32 + weights + state + batch * t_len * dims[-1][1] * FP32
    macs = sum(t_len * batch * 4 * h * ((i if n else 0) + h) for n, (i, h) in enumerate(dims))
    elementwise = sum(t_len * batch * (4 * 4 * h + 10 * h) for _, h in dims)
    return {"flops": float(2 * macs + elementwise), "bytes": float(n_bytes)}


def rowwise_costs(m: int, k: int, n: int, bias: bool = False) -> dict:
    """One row-wise product (M, K) @ (K, N) (+ b), fp32: x, w and b read
    once, the output written once; 2 operations per multiply-add and 1 per
    bias add."""
    n_bytes = (m * k + k * n + (n if bias else 0) + m * n) * FP32
    flops = 2 * m * n * k + (m * n if bias else 0)
    return {"flops": float(flops), "bytes": float(n_bytes)}


def score_products(config: dict, batch: int) -> list[dict]:
    """The four row-wise products of one batch score: the encoder's and the
    decoder's layer-0 input projections (the decoder's input is the latent
    repeated over the window), the dense head and each window's sum of
    squared error, at the model's widths."""
    t_len, d_in = config["timesteps"], config["input_dim"]
    enc, dec = segments(config)
    rows = batch * t_len
    return [rowwise_costs(rows, enc[0][0], 4 * enc[0][1]),
            rowwise_costs(rows, dec[0][0], 4 * dec[0][1]),
            rowwise_costs(rows, dec[-1][1], d_in),
            rowwise_costs(batch, t_len * d_in, 1)]


def forward_flops_per_window(config: dict) -> float:
    """Operations of the autoencoder's forward pass over one window: every
    layer's gate products (both), its gate and cell elementwise work, the
    dense head with its bias, and the squared error (difference, square,
    sum)."""
    t_len, d_in = config["timesteps"], config["input_dim"]
    dims = layer_dims(config)
    macs = sum(t_len * 4 * h * (i + h) for i, h in dims)
    elementwise = sum(t_len * (4 * 4 * h + 10 * h) for _, h in dims)
    head = 2 * t_len * dims[-1][1] * d_in + t_len * d_in
    return float(2 * macs + elementwise + head + 3 * t_len * d_in)
