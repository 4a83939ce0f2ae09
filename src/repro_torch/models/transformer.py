"""Model assembly — the port of ``repro.models.transformer``, for the
layer families ported so far: ``ssm`` (falcon-mamba) and the hybrid
(``rec`` and ``attn``, recurrentgemma).

Parameters keep the reference's layout: a dict with ``embed``,
``lm_head``, ``final_norm`` and one ``stack_<type>`` dict per layer type
whose tensors carry a leading layer axis, so a reference parameter tree
carries across one to one (``convert.params_from_jax``).  The reference
scans each stack with ``lax.scan``; here a Python loop runs over the
layer axis; a hybrid runs super-blocks of its pattern (rec, rec, attn),
then the layers of an incomplete last super-block.  As the reference does
with ``jax.checkpoint``, the backward pass rematerializes: with ``remat``
(the default) each layer body of a homogeneous stack and each hybrid
super-block keep only their input for the backward and run again inside
it, and so does each cross-entropy chunk, always.  Recomputation repeats
the same operations on the same inputs, so it changes memory and time,
and the loss and gradients only where an operation does not repeat its
bits; the kernels inside a rematerialized region (the scans, the
attention) launch once more per train step.

Vocabulary sizes are padded to multiples of 256 (``vocab_padded``);
labels never reference pad ids.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint, noop_context_fn

from .attention import attention_block
from .common import ModelConfig
from .layers import dense_init, rms_norm, swiglu
from .mamba import mamba_block
from .rglru import recurrent_block


def vocab_padded(cfg: ModelConfig) -> int:
    return ((cfg.vocab_size + 255) // 256) * 256


def _not_ported(t: str) -> NotImplementedError:
    return NotImplementedError(
        f"layer type {t!r} is not yet ported to repro_torch (the port "
        f"carries 'ssm', 'rec' and 'attn'; ROADMAP queue A brings the "
        f"others)")


# ===================================================================== init
def _init_attn(cfg: ModelConfig, gen: torch.Generator, n: int, device):
    """The hybrid's local-attention layer: attention and a SwiGLU MLP."""
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim

    def dense(shape, in_axis):
        return dense_init(gen, shape, in_axis, cfg.dtype, device)

    def norm():
        return torch.zeros((n, d), dtype=torch.float32, device=device)

    return {
        "norm1": norm(),
        "wq": dense((n, d, qd), 1),
        "wk": dense((n, d, kvd), 1),
        "wv": dense((n, d, kvd), 1),
        "wo": dense((n, qd, d), 1),
        "norm2": norm(),
        "w_gate": dense((n, d, cfg.d_ff), 1),
        "w_up": dense((n, d, cfg.d_ff), 1),
        "w_down": dense((n, cfg.d_ff, d), 1),
    }


def _init_rec(cfg: ModelConfig, gen: torch.Generator, n: int, device):
    """The hybrid's recurrent layer: the Griffin block and a SwiGLU MLP."""
    d, w, W = cfg.d_model, cfg.lru_width, cfg.conv_width

    def dense(shape, in_axis):
        return dense_init(gen, shape, in_axis, cfg.dtype, device)

    def norm():
        return torch.zeros((n, d), dtype=torch.float32, device=device)

    return {
        "norm1": norm(),
        "in_proj_rnn": dense((n, d, w), 1),
        "in_proj_gate": dense((n, d, w), 1),
        "conv_w": dense((n, w, W), 2),
        "conv_b": torch.zeros((n, w), dtype=cfg.dtype, device=device),
        "w_a": dense((n, w, w), 1),
        "w_x": dense((n, w, w), 1),
        "lambda_p": torch.full((n, w), 0.5, dtype=torch.float32,
                               device=device),
        "out_proj": dense((n, w, d), 1),
        "norm2": norm(),
        "w_gate": dense((n, d, cfg.d_ff), 1),
        "w_up": dense((n, d, cfg.d_ff), 1),
        "w_down": dense((n, cfg.d_ff, d), 1),
    }


def _init_ssm(cfg: ModelConfig, gen: torch.Generator, n: int, device):
    d, di, N, R, W = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank,
                      cfg.conv_width)

    def dense(shape, in_axis):
        return dense_init(gen, shape, in_axis, cfg.dtype, device)

    A = torch.arange(1, N + 1, dtype=torch.float32, device=device)
    return {
        "norm1": torch.zeros((n, d), dtype=torch.float32, device=device),
        "in_proj_u": dense((n, d, di), 1),
        "in_proj_z": dense((n, d, di), 1),
        "conv_w": dense((n, di, W), 2),
        "conv_b": torch.zeros((n, di), dtype=cfg.dtype, device=device),
        "x_proj": dense((n, di, R + 2 * N), 1),
        "dt_proj": dense((n, R, di), 1),
        "dt_bias": torch.zeros((n, di), dtype=cfg.dtype, device=device),
        "A_log": torch.log(A).expand(n, di, N).contiguous(),
        "D": torch.ones((n, di), dtype=torch.float32, device=device),
        "out_proj": dense((n, di, d), 1),
    }


_STACK_INIT = {"ssm": _init_ssm, "rec": _init_rec, "attn": _init_attn}


def stack_counts(cfg: ModelConfig) -> dict:
    counts: dict = {}
    for t in cfg.layer_types():
        counts[t] = counts.get(t, 0) + 1
    return counts


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda") -> dict:
    """The reference's parameter tree, drawn from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (so not the reference's numbers:
    tests carry the reference's across with ``convert.params_from_jax``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d, Vp = cfg.d_model, vocab_padded(cfg)
    params: dict = {"final_norm": torch.zeros((d,), dtype=torch.float32,
                                              device=device)}
    if cfg.input_mode == "tokens":
        params["embed"] = dense_init(gen, (Vp, d), 1, cfg.dtype, device)
    params["lm_head"] = dense_init(gen, (d, Vp), 0, cfg.dtype, device)
    for t, n in sorted(stack_counts(cfg).items()):
        if t not in _STACK_INIT:
            raise _not_ported(t)
        params[f"stack_{t}"] = _STACK_INIT[t](cfg, gen, n, device)
    return params


# =================================================================== forward
def _layer_body(cfg: ModelConfig, t: str, p, x, positions, impl: str):
    """One layer of type ``t``: pre-norm residual block(s)."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if t == "ssm":
        return x + mamba_block(cfg, p, h, impl=impl)
    if t == "attn":
        x = x + attention_block(cfg, p, h, positions, impl=impl,
                                window=cfg.local_window)
    elif t == "rec":
        x = x + recurrent_block(cfg, p, h, impl=impl)
    else:
        raise _not_ported(t)
    h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + swiglu(h2, p["w_gate"], p["w_up"], p["w_down"])


# The contexts a rematerialized region runs in, the forward pass's and the
# recomputation's (``torch.utils.checkpoint``'s ``context_fn``): a
# profiler may set it to time the recomputation inside the backward.
REMAT_CONTEXT = noop_context_fn


def _remat(fn, *args):
    """``fn(*args)`` keeping only its inputs for the backward pass, which
    runs ``fn`` again to get the rest (the reference's ``jax.checkpoint``).
    Outside autograd it is a plain call.  The model draws no random
    numbers, so no generator state is saved for the recomputation."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, context_fn=REMAT_CONTEXT)


def _layer(params, t: str, i: int) -> dict:
    """Layer ``i`` of ``stack_<t>``."""
    return {k: v[i] for k, v in params[f"stack_{t}"].items()}


def hidden_forward(cfg: ModelConfig, params, inputs, positions, *,
                   impl: str = "xla", remat: bool = True):
    """inputs: (B,S,d) embeddings -> the final-normed hidden states.  With
    ``remat``, each layer of a homogeneous stack and each hybrid
    super-block is rematerialized in the backward pass (the tail layers of
    an incomplete super-block are not, as in the reference)."""
    x = inputs
    types = cfg.layer_types()
    if cfg.family == "hybrid":
        pat = cfg.block_pattern or ("rec", "rec", "attn")
        n_super = len(types) // len(pat)
        per_block = {t: pat.count(t) for t in set(pat)}

        def super_body(x, idx):
            for j, t in enumerate(pat):
                i = idx * per_block[t] + pat[:j].count(t)
                x = _layer_body(cfg, t, _layer(params, t, i), x, positions,
                                impl)
            return x

        for idx in range(n_super):
            x = _remat(super_body, x, idx) if remat else super_body(x, idx)
        # tail: the layers of an incomplete last super-block
        used = {t: n_super * per_block[t] for t in per_block}
        for t in pat[:len(types) - n_super * len(pat)]:
            x = _layer_body(cfg, t, _layer(params, t, used[t]), x,
                            positions, impl)
            used[t] += 1
    else:                               # one stack, layer i at slot i
        for i, t in enumerate(types):
            if remat:
                x = _remat(_layer_body, cfg, t, _layer(params, t, i), x,
                           positions, impl)
            else:
                x = _layer_body(cfg, t, _layer(params, t, i), x, positions,
                                impl)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def embed_inputs(cfg: ModelConfig, params, batch):
    """Token embeddings (B,S,d) and their positions (B,S)."""
    if cfg.input_mode != "tokens":
        raise NotImplementedError("embedding inputs come with the vlm/audio "
                                  "families (ROADMAP queue A)")
    tokens = batch["tokens"].long()
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    return params["embed"][tokens], positions


def _chunk_loss(hc, lm_head, yc):
    """Σ (log Z - gold logit) over one chunk's tokens."""
    logits = (hc @ lm_head).float()                              # (B,c,Vp)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, yc[..., None].long())[..., 0]
    return torch.sum(logz - gold)


def lm_loss(cfg: ModelConfig, h, lm_head, labels, *, chunk: int = 512):
    """Chunked cross-entropy over the (padded) vocabulary; the mean is over
    all B·S tokens, as the reference's.  Each chunk is rematerialized in
    the backward pass, so one chunk's float32 logits, O(B·chunk·V), are
    alive at a time in the forward and in the backward."""
    B, S, d = h.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"seq_len {S} is not a multiple of the loss "
                         f"chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, chunk):
        total = total + _remat(_chunk_loss, h[:, i:i + chunk], lm_head,
                               labels[:, i:i + chunk])
    return total / (B * S)


def loss_fn(cfg: ModelConfig, params, batch, *, impl: str = "xla",
            remat: bool = True):
    """(loss, metrics) for a batch {"tokens", "labels"} of (B, S) ids;
    ``remat`` rematerializes the layers in the backward pass."""
    x, positions = embed_inputs(cfg, params, batch)
    h = hidden_forward(cfg, params, x, positions, impl=impl, remat=remat)
    loss = lm_loss(cfg, h, params["lm_head"], batch["labels"])
    return loss, {"ce_loss": loss}
