"""Sequence classification on the transformer trunk: the port of the JAX
package's ``models/classifier.py`` (the DDP classification leg's model,
the reference's ``AutoModelForSequenceClassification`` over a
SmolLM-class decoder with 2 labels).

The trunk's final hidden state at each row's last non-pad token goes
through a bias-free head ``cls_head`` (H, num_labels).  The tree is the
reference's, ``{"trunk": <the LM tree>, "cls_head": (H, num_labels)}``.
Rows are right-padded and the attention causal, so a real token never
attends to a pad: the pooled state does not depend on what the pads
hold.
"""

from __future__ import annotations

import torch

from . import transformer as T

__all__ = ["init_classifier_params", "classifier_logits",
           "classification_loss", "classification_accuracy"]


def init_classifier_params(cfg: T.TransformerConfig,
                           generator: torch.Generator, device=None,
                           num_labels: int = 2) -> dict:
    """The trunk from ``T.init_params`` and a zero head (uniform class
    probabilities at init, as the reference's)."""
    trunk = T.init_params(cfg, generator, device)
    head = torch.zeros((cfg.hidden_size, num_labels), dtype=cfg.dtype,
                       device=trunk["embed"].device)
    return {"trunk": trunk, "cls_head": head}


def classifier_logits(params: dict, input_ids: torch.Tensor,
                      attention_mask: torch.Tensor,
                      cfg: T.TransformerConfig, *, layer_hook=None,
                      return_aux: bool = False):
    """(B, S) ids and a 0/1 mask → (B, num_labels) logits in the trunk's
    dtype: the trunk, the hidden state at the last non-pad position,
    the head.  ``return_aux`` adds the trunk's summed aux loss (MoE; 0
    for a dense trunk)."""
    h, aux = T.hidden_states(params["trunk"], input_ids, cfg,
                             layer_hook=layer_hook, return_aux=True)
    last = (attention_mask.sum(dim=-1) - 1).clamp_min(0).long()
    pooled = h[torch.arange(h.shape[0], device=h.device), last]
    logits = pooled @ params["cls_head"].to(h.dtype)
    return (logits, aux) if return_aux else logits


def classification_loss(params: dict, batch: dict,
                        cfg: T.TransformerConfig, *,
                        layer_hook=None) -> torch.Tensor:
    """Mean softmax cross-entropy in f32 of ``batch`` (``input_ids`` and
    ``attention_mask`` (B, S), ``labels`` (B,): the collate of
    ``data.classification.pad_collate``), plus ``moe_aux_weight`` × the
    trunk's aux for an MoE config."""
    logits, aux = classifier_logits(params, batch["input_ids"],
                                    batch["attention_mask"], cfg,
                                    layer_hook=layer_hook, return_aux=True)
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, batch["labels"].long()[:, None])[:, 0]
    loss = torch.mean(logz - gold)
    if cfg.n_experts:
        loss = loss + cfg.moe_aux_weight * aux
    return loss


def classification_accuracy(params: dict, batch: dict,
                            cfg: T.TransformerConfig) -> torch.Tensor:
    """The fraction of rows whose argmax logit is the label (f32)."""
    logits = classifier_logits(params, batch["input_ids"],
                               batch["attention_mask"], cfg)
    return torch.mean((logits.argmax(dim=-1)
                       == batch["labels"].long()).float())
