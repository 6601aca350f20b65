"""Hooks that ``dp_cell.py`` runs in every rank before the data-parallel
driver: the CPU's thread budget, and each fault the cell can have planted
underneath its timed path."""

import torch


def none():
    torch.set_num_threads(2)


def state_unchanged():
    """A step that leaves the state unchanged."""
    from vlp_tpu_torch import optim
    none()
    optim.BertAdam.step = lambda self, finite=None: None


def half_batch():
    """Half of each rank's batch left out, the mean taken over the rest."""
    from vlp_tpu_torch import train_step as ts
    none()
    whole = ts.grads_with_accum

    def half(model, batch, seed, **kw):
        n = batch["input_ids"].shape[0] // 2
        return whole(model, {k: v[:n] for k, v in batch.items()}, seed,
                     **kw)

    ts.grads_with_accum = half


def no_exchange():
    """The exchange between the ranks left out: each steps on its own
    gradient."""
    from vlp_tpu_torch.parallel import dist
    none()
    dist.Dist.all_reduce_grads = lambda self, params, check=True: None


def rank_left_out():
    """The last rank's gradient left out of the all-reduce (it adds
    zeros), the mean still over every rank."""
    from vlp_tpu_torch.parallel import dist
    none()
    reduce = dist.Dist.all_reduce_grads

    def left_out(self, params, check=True):
        params = list(params)
        if self.rank == self.world - 1:
            for p in params:
                if p.grad is not None:
                    p.grad.zero_()
        return reduce(self, params, check=check)

    dist.Dist.all_reduce_grads = left_out
