"""Three steps of a plain trainer: loss, backward, Adam (torch defaults,
as the reference trainers use it), from the seeded weights and the batches
the loader handed the port."""

import torch


def leaf_norms(tensors):
    """{key: L2 norm as a float} of a dict of tensors."""
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def steps(loss_fn, params0, batches, lr):
    """Per-step losses before each update, the first step's gradient norms
    by leaf, and the norms of each leaf's change after all steps."""
    keys = sorted(params0)
    leaves = {k: params0[k].detach().clone().float().requires_grad_(True)
              for k in keys}
    opt = torch.optim.Adam([leaves[k] for k in keys], lr=lr,
                           betas=(0.9, 0.999), eps=1e-8)
    losses, grads = [], None
    for batch in batches:
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(leaves, batch)
        loss.backward()
        if grads is None:
            grads = leaf_norms({k: (leaves[k].grad if leaves[k].grad
                                    is not None else torch.zeros(1))
                                for k in keys})
        opt.step()
        losses.append(float(loss.detach()))
    change = leaf_norms({k: leaves[k] - params0[k].float() for k in keys})
    return losses, grads, change
