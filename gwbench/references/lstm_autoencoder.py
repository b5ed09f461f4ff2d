"""Plain PyTorch reference of the GW LSTM autoencoder (paper Sec. III-A),
with nothing of the program in it.

    encoder : LSTM layers over the window, the last layer's final h is the latent
    decoder : the latent repeated over the window, LSTM layers, every step kept
    head    : a dense layer per step, h_last -> input_dim
    score   : the mean squared reconstruction error of each window

An LSTM layer computes, per step, gates = x_t W_x + h_{t-1} W_h + b in the
order [i, f, g, o]; c = sigma(f) c + sigma(i) tanh(g); h = sigma(o)
tanh(c).  Weights are laid out as the program takes them (``w_x`` (in,
4h), ``w_h`` (h, 4h), ``b`` (4h,) per ``lstm_<i>``; ``dense`` ``w`` (h,
in) and ``b`` (in,)), so both are handed the same tensors.

Everything runs in fp32 with TF32 off.  ``tf32=True`` rounds both
operands of every product to TF32 (10 mantissa bits, round to nearest
even) and keeps fp32 sums: the control, one precision below the
configuration's.
"""

from __future__ import annotations

import math

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    return ((bits + 0x0FFF + keep) & ~0x1FFF).view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    """``a @ b`` with both operands rounded to TF32, fp32 sums; the
    backward's two products likewise, as the card computes them in TF32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        g = round_tf32(grad)
        return g @ round_tf32(b).t(), round_tf32(a).t() @ g


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    return _Tf32Matmul.apply(a, b) if tf32 else a @ b


def no_tf32() -> None:
    """fp32 products stay fp32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def layer_names(config: dict) -> list[str]:
    return [f"lstm_{i}" for i in range(len(config["hidden"]))]


def layer_dims(config: dict) -> list[tuple[int, int]]:
    dims, width = [], config["input_dim"]
    hidden, boundary = config["hidden"], config["latent_boundary"]
    for i, h in enumerate(hidden):
        if i == boundary:
            width = hidden[boundary - 1]
        dims.append((width, h))
        width = h
    return dims


def init_params(config: dict, generator: torch.Generator) -> dict:
    """Weights from one uniform draw on the generator's device: Glorot
    limits for ``w_x``, ``w_h`` and the head, biases within +-0.1 and the
    forget gate's shifted by 1."""
    dims = layer_dims(config)
    d_in, h_last = config["input_dim"], config["hidden"][-1]
    shapes = []
    for i, h in dims:
        lim_x, lim_h = math.sqrt(6.0 / (i + 4 * h)), math.sqrt(6.0 / (5 * h))
        shapes += [((i, 4 * h), lim_x), ((h, 4 * h), lim_h), ((4 * h,), 0.1)]
    shapes += [((h_last, d_in), math.sqrt(6.0 / (h_last + d_in))), ((d_in,), 0.1)]
    total = sum(math.prod(s) for s, _ in shapes)
    draw = torch.rand(total, generator=generator, device=generator.device) * 2 - 1
    leaves, at = [], 0
    for shape, lim in shapes:
        n = math.prod(shape)
        leaves.append((draw[at:at + n] * lim).reshape(shape).clone())
        at += n
    params = {}
    for name, (_, h) in zip(layer_names(config), dims):
        w_x, w_h, b = leaves[:3]
        leaves = leaves[3:]
        b[h:2 * h] += 1.0
        params[name] = {"w_x": w_x, "w_h": w_h, "b": b}
    params["dense"] = {"w": leaves[0], "b": leaves[1]}
    return params


def lstm_layer(p: dict, xs: torch.Tensor, tf32: bool) -> torch.Tensor:
    """(B, T, in) -> every step's h (B, T, h)."""
    batch, t_len, d_in = xs.shape
    hidden = p["w_h"].shape[0]
    xw = matmul(xs.reshape(batch * t_len, d_in), p["w_x"], tf32).reshape(batch, t_len, -1)
    h = xs.new_zeros(batch, hidden)
    c = xs.new_zeros(batch, hidden)
    hs = []
    for t in range(t_len):
        gates = xw[:, t] + matmul(h, p["w_h"], tf32) + p["b"]
        i, f, g, o = gates.split(hidden, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1)


def reconstruct(params: dict, x: torch.Tensor, config: dict, tf32: bool = False
                ) -> torch.Tensor:
    """(B, T, input_dim) -> the reconstruction, same shape."""
    names, boundary = layer_names(config), config["latent_boundary"]
    hs = x
    for name in names[:boundary]:
        hs = lstm_layer(params[name], hs, tf32)
    latent = hs[:, -1]
    hs = latent[:, None, :].expand(x.shape[0], x.shape[1], latent.shape[1])
    for name in names[boundary:]:
        hs = lstm_layer(params[name], hs, tf32)
    batch, t_len, hidden = hs.shape
    rec = matmul(hs.reshape(batch * t_len, hidden), params["dense"]["w"], tf32)
    return (rec + params["dense"]["b"]).reshape(x.shape)


def scores(params: dict, x: torch.Tensor, config: dict, tf32: bool = False) -> torch.Tensor:
    """Each window's mean squared reconstruction error, (B,)."""
    err = (reconstruct(params, x, config, tf32) - x) ** 2
    return err.reshape(x.shape[0], -1).mean(dim=1)


def scores_in_blocks(params: dict, x: torch.Tensor, config: dict, tf32: bool = False,
                     rows: int = 65536) -> torch.Tensor:
    with torch.no_grad():
        return torch.cat([scores(params, x[a:a + rows], config, tf32)
                          for a in range(0, x.shape[0], rows)])

