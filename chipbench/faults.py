"""Faults planted underneath a run, each a wrapper of a timed entry: of
``serve.prefill(model, tokens)`` for the prefill cells, of
``Trainer.step_fn(params, opt, batch, mark=None)`` for the training
cell.  The CPU tests drive whole runs through them and see ``correct``
come out false; ``calibrate.py`` reads the prefill faults on the card
beside the program, on the same requests.

A prefill batch routes and caps every row on its own, so its faults are
confined to rows: half of the batch left out, one slot's answer wrong.
No cell spans cards, so none can leave out an exchange between them.
"""
from __future__ import annotations

import torch

__all__ = ["PREFILL", "BATCHED", "TRAIN", "answer_altered", "token_altered", "half_batch",
           "one_slot", "state_unchanged", "half_rows", "labels_altered"]


def answer_altered(prefill):
    """Every answer's first logit raised where it is produced."""
    def run(model, tokens):
        out = prefill(model, tokens).clone()
        out[:, 0] += 20 * out.std()
        return out
    return run


def token_altered(prefill):
    """The prompts' tokens moved by one position before the prefill."""
    def run(model, tokens):
        return prefill(model, torch.roll(tokens, 1, dims=1))
    return run


def half_batch(prefill):
    """Half of the batch left out: the first half of the rows is
    prefilled, and the other half gets the mean of its answers."""
    def run(model, tokens):
        half = tokens.shape[0] // 2
        out = prefill(model, tokens[:half])
        rest = out.float().mean(dim=0, keepdim=True).to(out.dtype)
        return torch.cat([out, rest.expand(tokens.shape[0] - half, -1)])
    return run


def one_slot(prefill):
    """The last slot gets the first slot's answer."""
    def run(model, tokens):
        out = prefill(model, tokens).clone()
        out[-1] = out[0]
        return out
    return run


def state_unchanged(step_fn):
    """A step that computes the loss and returns its state unchanged."""
    def run(params, opt, batch, mark=None):
        model = step_fn.__self__.model
        with torch.no_grad():
            loss = model.loss(batch)
        return params, opt, {"loss": loss}
    return run


def half_rows(step_fn):
    """Half of each row left out: the step trains on its first half, the
    loss the mean over it."""
    def run(params, opt, batch, mark=None):
        half = batch["tokens"].shape[1] // 2
        return step_fn(params, opt, {k: v[:, :half] for k, v in batch.items()}, mark=mark)
    return run


def labels_altered(step_fn):
    """Every label moved to the next token id where the batch is fed."""
    def run(params, opt, batch, mark=None):
        vocab = step_fn.__self__.cfg.vocab_size
        return step_fn(params, opt, {**batch, "labels": (batch["labels"] + 1) % vocab}, mark=mark)
    return run


# by name: every prefill cell can have these, a batched one these too
PREFILL = {"answer_altered": answer_altered, "token_altered": token_altered}
BATCHED = {"half_batch": half_batch, "one_slot": one_slot}
TRAIN = {"state_unchanged": state_unchanged, "half_batch": half_rows,
         "labels_altered": labels_altered}
