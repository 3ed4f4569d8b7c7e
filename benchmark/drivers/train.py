"""Training: the port's train step, driven step after step.

Set-up builds one train step (model and optimizer state) from the
benchmark's weights and drives it through its first ``CHECKED`` steps with
the window's own call on distinct batches of the mix's pool; the window
then goes on with the same object. Each step draws its dropout from a
generator seeded from (run seed, step). A step counts when the window's
closing synchronize has passed it.

The check follows those first steps with the plain reference from the same
weights, batches and dropout generators, and compares each step's loss,
each leaf's first gradient as the optimizer received it (read back from
its state after one step) and each leaf's change over the steps, by the
worst leaf.
"""

import math
import time

import numpy as np
import torch

from .. import trace as spans
from .. import weights
from ..harness import Record
from ..reference import plain

CHECKED = 3

# A leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone (a conv bias ahead of a train-mode norm): its
# change is not compared
STILL = 1e-3


def dropout_generator(ctx, step):
    return weights.generator(ctx.seed, ctx.device, 'dropout', step)


def first_gradient_norms(model, optimizer):
    """Each leaf's gradient of the first step, from the optimizer's state
    after it: Adam keeps (1 - beta1) g, Adadelta (1 - rho) g^2."""

    group = optimizer.param_groups[0]
    norms = {}
    for name, param in model.named_parameters():
        state = optimizer.state.get(param, {})
        if 'exp_avg' in state:
            norm = state['exp_avg'].norm() / (1.0 - group['betas'][0])
        elif 'square_avg' in state:
            norm = (state['square_avg'].sum() / (1.0 - group['rho'])).sqrt()
        else:
            norm = torch.zeros(())
        norms[name] = norm

    return {name: float(norm) for name, norm in norms.items()}


class Optimizer:
    """The reference's optimizer update, written out: Adam or Adadelta
    with torch's defaults."""

    def __init__(self, spec, params):
        self.name = spec['name']
        self.lr = spec['lr']
        self.steps = 0
        self.state = {name: (torch.zeros_like(p), torch.zeros_like(p))
                      for name, p in params.items()}

    @torch.no_grad()
    def update(self, params, grads):
        self.steps += 1
        for name, param in params.items():
            g = grads[name]
            a, b = self.state[name]
            if self.name == 'Adam':
                beta1, beta2, eps = 0.9, 0.999, 1e-8
                a.mul_(beta1).add_((1 - beta1) * g)
                b.mul_(beta2).add_((1 - beta2) * g * g)
                m = a / (1 - beta1 ** self.steps)
                v = b / (1 - beta2 ** self.steps)
                param -= self.lr * m / (v.sqrt() + eps)
            elif self.name == 'Adadelta':
                rho, eps = 0.9, 1e-6
                a.mul_(rho).add_((1 - rho) * g * g)
                delta = (b + eps).sqrt() / (a + eps).sqrt() * g
                b.mul_(rho).add_((1 - rho) * delta * delta)
                param -= self.lr * delta
            else:
                raise ValueError(f'no reference update for {self.name}')


def reference_steps(ctx, params, names, pool, precision):
    """The reference's first ``CHECKED`` steps -> (losses, first gradient
    norms, change norms), by leaf name."""

    leaves = {name: params[name].clone().requires_grad_(True)
              for name in names}
    values = dict(params, **leaves)
    optimizer = Optimizer(ctx.workload['optimizer'], leaves)
    losses, grad_norms = [], {}
    with plain.exact_float32():
        for step in range(CHECKED):
            loss = ctx.reference.loss(values, pool[step], ctx.config,
                                      precision, dropout_generator(ctx, step))
            grads = dict(zip(names, torch.autograd.grad(
                loss, [leaves[name] for name in names])))
            losses.append(float(loss.detach()))
            if step == 0:
                grad_norms = {name: float(g.norm()) for name, g in
                              grads.items()}
            optimizer.update(leaves, grads)

    changes = {name: float((leaves[name].detach() - params[name]).norm())
               for name in names}

    return losses, grad_norms, changes


def gaps(program, reference):
    """(loss gap, worst leaf's gradient gap, worst moved leaf's change gap)
    of two sets of readings, each ``(losses, grad norms, change norms)``."""

    losses, grads, changes = program
    ref_losses, ref_grads, ref_changes = reference
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(losses, ref_losses))
    median_grad = float(np.median(list(ref_grads.values())))
    grad_gap = max(abs(grads[name] - g) / max(g, median_grad, 1e-30)
                   for name, g in ref_grads.items())
    moved = [name for name, g in ref_grads.items()
             if g >= STILL * median_grad]
    median_change = float(np.median([ref_changes[name] for name in moved]))
    update_gap = max(abs(changes[name] - ref_changes[name]) /
                     max(ref_changes[name], median_change, 1e-30)
                     for name in moved)

    return loss_gap, grad_gap, update_gap


class Bench:

    def __init__(self, ctx):
        self.ctx = ctx
        self.workload = ctx.workload
        self.config = ctx.config
        self.profiler = None

    def setup(self):
        ctx = self.ctx
        self.params = weights.make(ctx.reference.parameters(self.config),
                                   ctx.seed, ctx.device)
        ctx.mark('weights')
        self.pool = ctx.generator.make(ctx.traffic, self.config,
                                       ctx.reference, ctx.seed, ctx.device)
        ctx.mark('traffic')
        self.model, self.optimizer, self.step = ctx.program.training(
            self.config, self.params, ctx.device, self.workload['optimizer'])
        spans.hook_module(self.model, 'bench.forward')
        self.names = [name for name, _ in self.model.named_parameters()]
        ctx.mark('program')

        # The checked steps, through the window's own call
        losses = []
        for step in range(CHECKED):
            loss = self._step(step)
            losses.append(float(loss['loss_total']))
            if step == 0:
                grads = first_gradient_norms(self.model, self.optimizer)
        changes = {name: float((param.detach() - self.params[name]).norm())
                   for name, param in self.model.named_parameters()}
        self.readings = losses, grads, changes
        self.next = CHECKED

        if ctx.trace:
            self.profiler = spans.Profiler(ctx.device)
            self.profiler.warm()

    def _step(self, step):
        with spans.span('bench.step'):
            return self.step(self.pool[step % len(self.pool)],
                             dropout_generator(self.ctx, step))

    def _loop(self, count=None, seconds=None):
        done = 0
        loss = None
        start = time.perf_counter()
        while not (count is not None and done >= count or
                   seconds is not None and
                   time.perf_counter() - start >= seconds):
            loss = self._step(self.next)
            self.next += 1
            done += 1
        if self.ctx.device.type == 'cuda':
            torch.cuda.synchronize(self.ctx.device)

        return done, time.perf_counter() - start, loss

    def window(self, seconds):
        steps, elapsed, loss = self._loop(seconds=seconds)
        traced = None
        if self.profiler is not None:
            items = self.workload['trace_items']
            with self.profiler.stretch():
                more, more_s, loss = self._loop(count=items)
            steps += more
            elapsed += more_s
            traced = self.profiler.reduce(items)

        finite = loss is not None and math.isfinite(float(loss['loss_total']))
        batch = self.pool[0]['features']

        return Record(self.ctx, elapsed, {'steps': steps}, attempted=steps,
                      failed=0 if finite else steps,
                      shape={'batch': batch.shape[0],
                             'frames': batch.shape[-1]},
                      trace=traced)

    def check(self):
        ctx, limits = self.ctx, self.workload['limits']
        self.model = self.optimizer = self.step = None
        if ctx.device.type == 'cuda':
            torch.cuda.empty_cache()

        reference = reference_steps(ctx, self.params, self.names, self.pool,
                                    'float32')
        loss_gap, grad_gap, update_gap = gaps(self.readings, reference)

        return [('loss_gap', loss_gap, limits['loss_gap']),
                ('grad_gap', grad_gap, limits['grad_gap']),
                ('update_gap', update_gap, limits['update_gap'])]
