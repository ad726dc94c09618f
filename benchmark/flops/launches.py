"""Operations and bytes of one launch of a port kernel, from the shapes its
span records (``port.kernel.<family>`` of plastic_unet_tpu_torch.utils.profiling),
counted as ``unet_res.py`` counts: 2 x 9 x H x W x Cin x Cout a 3x3 conv,
2 x nbf^3 a sample's head; each input read once and each output written
once, the weights and biases read (and their gradients written) once a
launch. A workspace that a launch writes and its reduction reads back (the
weight gradient's chunks, the fused backward's per-sample sums) is not
counted, as ``unet_res.tail_work`` does not count it.
"""

from __future__ import annotations

F32 = 4


def conv3x3(a: dict) -> tuple[float, float]:
    """The conv3x3 kernel, forward or input gradient (``flip``): ``x`` (B, H,
    W, Cin) in, out (B, H, W, Cout); a residual and an output gate of the
    output's size in, an input gate of the input's size in and the masked
    input out."""
    px = a["b"] * a["h"] * a["w"]
    acts = px * a["cin"] * (1 + 2 * a["in_gate"]) + px * a["cout"] * (1 + a["res"] + a["gate"])
    return 2.0 * 9 * px * a["cin"] * a["cout"], F32 * float(acts + 9 * a["cin"] * a["cout"] + a["cout"] * a["bias"])


def wgrad(a: dict) -> tuple[float, float]:
    """The weight gradient (and its chunks' reduction): x and d in, dW and db out."""
    px = a["b"] * a["h"] * a["w"]
    return 2.0 * 9 * px * a["cin"] * a["cout"], F32 * float(px * (a["cin"] + a["cout"]) + 9 * a["cin"] * a["cout"]
                                                             + a["cout"])


def _tail_weights(c: int) -> int:
    return 4 * (9 * c * c + c)


def tail_fwd(a: dict) -> tuple[float, float]:
    """The fused residual tail: four convs at C -> C; x0 in, out out (with
    ``keep`` also pre11, x1 and pre21 out); the four weights and biases in."""
    px = a["b"] * a["h"] * a["w"]
    return 4 * 2.0 * 9 * px * a["c"] ** 2, F32 * float(px * a["c"] * (2 + 3 * a["keep"]) + _tail_weights(a["c"]))


def tail_bwd(a: dict) -> tuple[float, float]:
    """The fused tail backward and its sample reduction: the input and weight
    gradients of four convs; g and the five saved tensors in, dx0 out; the
    weights in and their gradients out."""
    px = a["b"] * a["h"] * a["w"]
    return 8 * 2.0 * 9 * px * a["c"] ** 2, F32 * float(7 * px * a["c"] + 2 * _tail_weights(a["c"]))


def head(a: dict) -> tuple[float, float]:
    """The plastic head: activin and hebb in, activ, activout and the new
    trace out (B, n, n) each; w, alpha (one element when yoked) and eta in."""
    b, n = a["b"], a["n"]
    alpha = 1 if a.get("scalar_alpha") else n * n
    return 2.0 * b * n ** 3, F32 * float(5 * b * n * n + n * n + alpha + 1)


WORK = {"conv3x3": conv3x3, "wgrad": wgrad, "tail_fwd": tail_fwd, "tail_bwd": tail_bwd, "head": head}


def work(family: str, attrs: dict) -> tuple[float, float]:
    """(operations, bytes) of one launch of ``family`` with the span's ``attrs``."""
    return WORK[family](attrs)
