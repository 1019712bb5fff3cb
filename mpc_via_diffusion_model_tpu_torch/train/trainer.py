"""Training loop: port of ``mpc_via_diffusion_model_tpu/train/trainer.py``.

One train step is the loss, its gradients by autograd, optax's
clip-by-global-norm and Adam, the NaN guard and the EMA, computed on the
device without a host sync, so that a chunk of steps runs as JAX's
``lax.scan`` does. The parameters, Adam's two moments and the EMA are each
one flat float32 buffer (``ParamLayout`` names the slices); the module is
called on views of the flat parameters in place of its own (as
``torch.func.functional_call`` calls it), so every ``TrainState`` is a value
of its own, as in JAX.

Semantics kept, each as optax and the JAX step compute it:

- the clip scales the gradients by ``max_norm / g_norm`` only when
  ``g_norm >= max_norm``, as ``(g / g_norm) * max_norm``, with no epsilon;
- Adam with b1 0.9, b2 0.999 and eps 1e-8 added after the square root,
  both moments bias-corrected by the incremented count;
- the NaN guard: when the loss or any gradient is not finite, the
  parameters and Adam's state (its count too) stay as they were, the step
  counter still advances and ``update_skipped`` is reported;
- the EMA of the guarded parameters: a hard copy before ``step_start_ema``,
  then ``ema * decay + p * (1 - decay)`` every ``update_ema_every``-th step
  of the incremented counter.

Checkpoints are the JAX package's payload (``params``, ``ema_params`` and
Adam's moments in the flax layout, ``opt_state`` in optax's structure,
``step``, ``extra``), written atomically; ``load_checkpoint`` also reads one
that the JAX package wrote, its optax classes mapped to the stand-ins below
without importing optax. The tracer of ``native/`` and the data-parallel
step wait for their ports (ROADMAP.md A8, A9).
"""
from __future__ import annotations

import dataclasses
import inspect
import io
import os
import pickle
import time
from typing import Any, Callable, ClassVar, Dict, List, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..diffusion.gaussian_diffusion import GaussianDiffusion
from ..models.weights import from_flax_params, to_flax_params
from ..utils.device import resolve_device

__all__ = ["EarlyStopper", "EmptyState", "Optimizer", "ParamLayout", "ScaleByAdamState",
           "TrainState", "Trainer", "diffusion_loss", "load_checkpoint", "make_custom_train_step",
           "make_eval_step", "make_optimizer", "make_scanned_train_steps", "make_train_step",
           "save_checkpoint", "value_and_grad"]

# A step's draws: a torch.Generator, or staged tensors by name ('t', 'noise', 'mask'; a
# chunk's also 'idx', each with the steps along its first axis).
Draws = Union[torch.Generator, Mapping[str, torch.Tensor], None]


class EmptyState(NamedTuple):
    """Stand-in for optax's ``EmptyState`` (the clip's and the lr scale's state)."""


class ScaleByAdamState(NamedTuple):
    """Stand-in for optax's ``ScaleByAdamState``."""
    count: Any
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class ParamLayout:
    """Where each parameter of a module lies in a flat buffer: its name,
    shape and offset, in ``named_parameters`` order."""

    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    offsets: Tuple[int, ...]
    numel: int

    @classmethod
    def of(cls, model: nn.Module) -> "ParamLayout":
        names, shapes, offsets, n = [], [], [], 0
        for name, p in model.named_parameters():
            names.append(name)
            shapes.append(tuple(p.shape))
            offsets.append(n)
            n += p.numel()
        return cls(tuple(names), tuple(shapes), tuple(offsets), n)

    def flatten(self, tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """One flat copy of a dict of tensors under the layout's names."""
        return torch.cat([tensors[n].detach().reshape(-1) for n in self.names])

    def views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Each parameter's view into ``flat``."""
        sizes = [int(np.prod(s, dtype=np.int64)) for s in self.shapes]
        return {n: v.view(s) for n, s, v in zip(self.names, self.shapes, flat.split(sizes))}


@dataclasses.dataclass(frozen=True)
class TrainState:
    params: torch.Tensor               # flat
    ema_params: torch.Tensor           # flat
    opt_state: ScaleByAdamState        # count (int32 scalar), mu and nu (flat)
    step: torch.Tensor                 # int32 scalar
    layout: ParamLayout


def _call_summary(summary_fn, params, generator, step):
    """Calls a summary hook with the training step when it takes one."""
    try:
        sig = inspect.signature(summary_fn)
    except (TypeError, ValueError):
        return summary_fn(params, generator)
    accepts_step = "step" in sig.parameters or any(
        p.kind == inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values())
    if accepts_step:
        return summary_fn(params, generator, step=step)
    return summary_fn(params, generator)


class EarlyStopper:
    """Stops after ``patience`` validations without improvement; patience -1
    disables it."""

    def __init__(self, patience: int = -1, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.counter = 0
        self.min_validation_loss = float("inf")

    def early_stop(self, validation_loss: float) -> bool:
        if self.patience == -1:
            return False
        if validation_loss < self.min_validation_loss:
            self.min_validation_loss = validation_loss
            self.counter = 0
        elif validation_loss > self.min_validation_loss + self.min_delta:
            self.counter += 1
            if self.counter >= self.patience:
                return True
        return False


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``optax.chain(clip_by_global_norm(clip_grad_max_norm), adam(lr))`` on
    flat buffers, with optax's b1 0.9, b2 0.999 and eps 1e-8."""

    lr: float
    clip_grad_max_norm: float = 1.0
    b1: ClassVar[float] = 0.9
    b2: ClassVar[float] = 0.999
    eps: ClassVar[float] = 1e-8

    def init(self, params: torch.Tensor) -> ScaleByAdamState:
        return ScaleByAdamState(torch.zeros((), dtype=torch.int32, device=params.device),
                                torch.zeros_like(params), torch.zeros_like(params))

    def update(self, grads: torch.Tensor, state: ScaleByAdamState):
        """(updates, new state); the updates are added to the parameters."""
        g_norm = torch.sqrt(torch.sum(torch.square(grads)))
        g = torch.where(g_norm < self.clip_grad_max_norm, grads,
                        (grads / g_norm) * self.clip_grad_max_norm)
        mu = (1 - self.b1) * g + self.b1 * state.mu
        nu = (1 - self.b2) * torch.square(g) + self.b2 * state.nu
        count = state.count + 1
        c = count.to(grads.dtype)
        mu_hat = mu / (1 - torch.pow(torch.full_like(c, self.b1), c))
        nu_hat = nu / (1 - torch.pow(torch.full_like(c, self.b2), c))
        updates = mu_hat / (torch.sqrt(nu_hat) + self.eps) * -self.lr
        return updates, ScaleByAdamState(count, mu, nu)


def make_optimizer(lr: float, clip_grad_max_norm: float = 1.0) -> Optimizer:
    return Optimizer(lr, clip_grad_max_norm)


def value_and_grad(loss_fn: Callable, layout: ParamLayout, params: torch.Tensor, inputs_norm,
                   condition_norm, draws: Draws = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, flat gradient) of ``loss_fn`` at the flat ``params``: autograd
    through leaves that share ``params``' memory."""
    leaves = {n: v.requires_grad_() for n, v in layout.views(params.detach()).items()}
    loss = loss_fn(leaves, inputs_norm, condition_norm, draws)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    g = torch.cat([torch.zeros_like(p).reshape(-1) if d is None else d.reshape(-1)
                   for p, d in zip(leaves.values(), grads)])
    return loss.detach(), g


def make_custom_train_step(loss_fn: Callable, optimizer: Optimizer, ema_decay: float = 0.995,
                           step_start_ema: int = 1000, update_ema_every: int = 10):
    """The NaN-guarded EMA train step of any loss.

    ``loss_fn(params, inputs_norm, condition_norm, draws) -> scalar``, where
    ``params`` maps each parameter name to a tensor. Returns
    ``step(state, inputs_norm, condition_norm, draws) -> (state, metrics)``,
    ``metrics`` holding ``loss`` and ``update_skipped`` as tensors on the
    device; the step never waits for the device."""

    def train_step(state: TrainState, inputs_norm, condition_norm, draws: Draws = None):
        loss, g = value_and_grad(loss_fn, state.layout, state.params, inputs_norm, condition_norm,
                                 draws)
        ok = torch.isfinite(loss) & torch.isfinite(g).all()

        updates, new_opt = optimizer.update(g, state.opt_state)
        params = torch.where(ok, state.params + updates, state.params)
        new_opt = ScaleByAdamState(*(torch.where(ok, new, old)
                                     for new, old in zip(new_opt, state.opt_state)))

        step = state.step + 1
        do_update = (step >= step_start_ema) & (step % update_ema_every == 0)
        decayed = state.ema_params * ema_decay + params * (1.0 - ema_decay)
        ema = torch.where(step < step_start_ema, params,
                          torch.where(do_update, decayed, state.ema_params))
        new_state = TrainState(params, ema, new_opt, step, state.layout)
        return new_state, {"loss": loss, "update_skipped": ~ok}

    return train_step


def _split_draws(draws: Draws):
    """(generator, staged tensors) of a step's draws."""
    if draws is None or isinstance(draws, torch.Generator):
        return draws, {}
    return None, dict(draws)


def _functional(model: nn.Module):
    """``call(params, *args)``: ``model(*args)`` with its parameters replaced
    by ``params`` (a dict by name) for the call, as ``torch.func.functional_call``
    does, with the submodule of each name looked up once."""
    slots = [(name, model.get_submodule(name.rpartition(".")[0]), name.rpartition(".")[2])
             for name, _ in model.named_parameters()]

    def call(params, *args):
        originals = [mod._parameters[attr] for _, mod, attr in slots]
        try:
            for name, mod, attr in slots:
                mod._parameters[attr] = params[name]
            return model(*args)
        finally:
            for (_, mod, attr), p in zip(slots, originals):
                mod._parameters[attr] = p

    return call


def diffusion_loss(diffusion: GaussianDiffusion, model: nn.Module):
    """``loss_fn(params, inputs_norm, condition_norm, draws)``: the diffusion
    loss of ``model``'s forward on ``params`` (a dict by parameter name)."""
    call = _functional(model)

    def loss_fn(params, inputs_norm, condition_norm, draws: Draws = None):
        generator, staged = _split_draws(draws)
        denoise = lambda x, t, c, m: call(params, x, t, c, m)
        return diffusion.loss(denoise, inputs_norm, condition_norm, generator=generator, **staged)

    return loss_fn


def make_train_step(diffusion: GaussianDiffusion, model: nn.Module, optimizer: Optimizer,
                    ema_decay: float = 0.995, step_start_ema: int = 1000,
                    update_ema_every: int = 10):
    """The train step of the diffusion loss of ``model`` (the module whose
    forward the step calls on the state's parameters)."""
    return make_custom_train_step(diffusion_loss(diffusion, model), optimizer, ema_decay,
                                  step_start_ema, update_ema_every)


def make_scanned_train_steps(train_step: Callable, n_inner: int):
    """``chunk(state, inputs_all, cond_all, batch_size, draws=None,
    per_step=False) -> (state, mean loss)``: ``n_inner`` train steps, each
    on a minibatch gathered on the device from the whole normalized arrays,
    without a host sync. ``draws`` is a ``torch.Generator`` on the data's
    device, from which each step draws its indices, then its loss draws; or
    staged tensors ``idx`` (n_inner, B) and any of ``t``, ``noise`` and
    ``mask``, each with the steps along its first axis. With ``per_step``
    the (n_inner,) losses come back instead of their mean."""

    def chunk(state: TrainState, inputs_all, cond_all, batch_size: int, draws: Draws = None,
              per_step: bool = False):
        generator, staged = _split_draws(draws)
        n, losses = inputs_all.shape[0], []
        for i in range(n_inner):
            if staged:
                idx = staged["idx"][i]
                step_draws = {k: v[i] for k, v in staged.items() if k != "idx"}
            else:
                idx = torch.randint(0, n, (batch_size,), generator=generator,
                                    device=inputs_all.device)
                step_draws = generator
            state, metrics = train_step(state, inputs_all[idx], cond_all[idx], step_draws)
            losses.append(metrics["loss"])
        losses = torch.stack(losses)
        return state, (losses if per_step else torch.mean(losses))

    return chunk


def make_eval_step(diffusion: GaussianDiffusion, model: nn.Module, layout: ParamLayout):
    """``eval_step(params, inputs_norm, condition_norm, draws) -> loss`` on
    the flat parameters, without gradients."""
    loss_fn = diffusion_loss(diffusion, model)

    @torch.no_grad()
    def eval_step(params: torch.Tensor, inputs_norm, condition_norm, draws: Draws = None):
        return loss_fn(layout.views(params), inputs_norm, condition_norm, draws)

    return eval_step


# Checkpoints: the JAX package's payload, a pickled dict of numpy arrays in the flax layout.

def _flax(state: TrainState, flat: torch.Tensor) -> Dict:
    return to_flax_params(state.layout.views(flat))


def save_checkpoint(path: str, state: TrainState, extra: Optional[Dict] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    opt = state.opt_state
    adam = ScaleByAdamState(np.asarray(opt.count.item(), np.int32), _flax(state, opt.mu),
                            _flax(state, opt.nu))
    payload = {
        "params": _flax(state, state.params),
        "ema_params": _flax(state, state.ema_params),
        "opt_state": (EmptyState(), (adam, EmptyState())),
        "step": int(state.step.item()),
        "extra": extra or {},
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)  # atomic: no torn checkpoint


class _CheckpointUnpickler(pickle.Unpickler):
    """Reads optax's state classes as the stand-ins above."""

    _OPTAX = {"EmptyState": EmptyState, "ScaleByAdamState": ScaleByAdamState}

    def find_class(self, module: str, name: str):
        if module.split(".")[0] == "optax":
            if name not in self._OPTAX:
                raise pickle.UnpicklingError(f"optax class {module}.{name} has no stand-in")
            return self._OPTAX[name]
        return super().find_class(module, name)


def load_checkpoint(path: str, layout: ParamLayout, device=None) -> Tuple[TrainState, Dict]:
    """(state, extra) of a checkpoint that the port or the JAX package wrote,
    in the dtype it was written in, on ``device`` (``cuda`` unless given)."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        payload = _CheckpointUnpickler(io.BytesIO(f.read())).load()
    flat = lambda tree: layout.flatten(from_flax_params(tree, dtype=None)).to(dev)
    adam = payload["opt_state"][1][0]  # (clip's state, (Adam's, the lr scale's))
    opt = ScaleByAdamState(torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32, device=dev),
                           flat(adam.mu), flat(adam.nu))
    state = TrainState(flat(payload["params"]), flat(payload["ema_params"]), opt,
                       torch.tensor(int(payload["step"]), dtype=torch.int32, device=dev), layout)
    return state, payload.get("extra", {})


class Trainer:
    """The loop around the train step: per-step or chunked fitting,
    validation, summaries, checkpoints, early stopping and the loss history
    ``.npy`` files. ``model`` holds the initial weights; it runs on
    ``device`` (``cuda`` unless given)."""

    def __init__(self, diffusion: GaussianDiffusion, model: nn.Module, lr: float = 3e-3,
                 clip_grad_max_norm: float = 1.0, ema_decay: float = 0.995,
                 step_start_ema: int = 1000, update_ema_every: int = 10,
                 checkpoint_dir: Optional[str] = None, train_step_fn: Optional[Callable] = None,
                 device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.diffusion = diffusion.to(self.device)
        self.optimizer = make_optimizer(lr, clip_grad_max_norm)
        self.train_step = train_step_fn or make_train_step(
            self.diffusion, self.model, self.optimizer, ema_decay, step_start_ema,
            update_ema_every)
        layout = ParamLayout.of(self.model)
        self.eval_step = make_eval_step(self.diffusion, self.model, layout)
        params = layout.flatten(dict(self.model.named_parameters()))
        self.state = TrainState(params, params.clone(), self.optimizer.init(params),
                                torch.zeros((), dtype=torch.int32, device=self.device), layout)
        self.checkpoint_dir = checkpoint_dir
        self.train_losses: List[Tuple[int, float]] = []
        self.val_losses: List[Tuple[int, float]] = []

    def resume(self, path: str) -> None:
        self.state, _ = load_checkpoint(path, self.state.layout, self.device)

    def ema_state_dict(self) -> Dict[str, torch.Tensor]:
        """The EMA weights under the module's parameter names."""
        return self.state.layout.views(self.state.ema_params)

    def fit(self, dataset, num_train_steps: int, batch_size: int = 512,
            generator: Optional[torch.Generator] = None, val_dataset=None,
            steps_til_summary: int = 2000, steps_til_checkpoint: int = 10000,
            steps_per_validation: int = 10, early_stopper_patience: int = -1,
            log_fn: Callable[[str], None] = print, summary_fn: Optional[Callable] = None,
            metrics_writer=None, chunk_size: int = 1) -> TrainState:
        """Trains until the state's step reaches ``num_train_steps``, drawing
        from ``generator`` (on the data's device; seeded 0 unless given).
        ``summary_fn(ema_params, generator[, step=]) -> dict`` runs every
        ``steps_til_summary`` on the EMA weights (a dict under the module's
        parameter names), its record going to ``metrics_writer.log(record,
        step=)`` when one is given. ``chunk_size > 1`` runs that many steps
        per ``make_scanned_train_steps`` chunk, and the summary, validation
        and checkpoint cadences then fire at the chunk that crosses them;
        the loss logged is the chunk's mean. The host waits for the device
        only where it logs."""
        gen = generator or torch.Generator(device=dataset.device).manual_seed(0)
        stopper = EarlyStopper(early_stopper_patience)
        t0 = time.time()
        start = int(self.state.step.item())
        chunk = make_scanned_train_steps(self.train_step, chunk_size) if chunk_size > 1 else None
        crossed = lambda it, period: (it // period) > ((it - chunk_size) // period)
        it = start
        while it < num_train_steps:
            if chunk is None:
                inputs, cond = dataset.batch(gen, batch_size)
                self.state, metrics = self.train_step(self.state, inputs, cond, gen)
                loss, it = metrics["loss"], it + 1
                log_now = it % steps_til_summary == 0 or it - 1 == start
                ckpt_now = it % steps_til_checkpoint == 0
            else:
                self.state, loss = chunk(self.state, dataset.inputs_normalized,
                                         dataset.condition_normalized, batch_size, gen)
                it += chunk_size
                log_now = crossed(it, steps_til_summary) or it - chunk_size == start
                ckpt_now = crossed(it, steps_til_checkpoint)
            if log_now and self._summary(it, num_train_steps, float(loss), start, t0, val_dataset,
                                         batch_size, steps_per_validation, gen, stopper, log_fn,
                                         summary_fn, metrics_writer):
                break
            if self.checkpoint_dir and ckpt_now:
                self.checkpoint(tag=f"step_{it:06d}")
        if self.checkpoint_dir:
            self.checkpoint(tag="final")
        return self.state

    def _summary(self, it, num_train_steps, train_loss, start, t0, val_dataset, batch_size,
                 steps_per_validation, gen, stopper, log_fn, summary_fn, metrics_writer) -> bool:
        """Logs step ``it``; True when the early stopper says stop."""
        self.train_losses.append((it, train_loss))
        msg = f"step {it}/{num_train_steps} loss {train_loss:.6f}"
        record = {"train_loss": train_loss}
        if val_dataset is not None:
            val_loss = self.validate(val_dataset, batch_size, steps_per_validation, gen)
            self.val_losses.append((it, val_loss))
            record["val_loss"] = val_loss
            msg += f" val {val_loss:.6f}"
            if stopper.early_stop(val_loss):
                log_fn(f"early stop at step {it}")
                return True
        if summary_fn is not None:
            record.update(_call_summary(summary_fn, self.ema_state_dict(), gen, it))
        if metrics_writer is not None:
            metrics_writer.log(record, step=it)
        log_fn(msg + f" ({(it - start) / max(time.time() - t0, 1e-9):.1f} steps/s)")
        return False

    def validate(self, val_dataset, batch_size: int, n_batches: int,
                 generator: Optional[torch.Generator] = None) -> float:
        losses = []
        for _ in range(n_batches):
            inputs, cond = val_dataset.batch(generator, batch_size)
            losses.append(float(self.eval_step(self.state.params, inputs, cond, generator)))
        return float(np.mean(losses))

    def checkpoint(self, tag: str = "current") -> None:
        if self.checkpoint_dir is None:
            raise ValueError("Trainer.checkpoint needs a checkpoint_dir")
        save_checkpoint(os.path.join(self.checkpoint_dir, f"{tag}.ckpt"), self.state)
        save_checkpoint(os.path.join(self.checkpoint_dir, "current.ckpt"), self.state)
        for name, losses in (("train_losses", self.train_losses), ("val_losses", self.val_losses)):
            np.save(os.path.join(self.checkpoint_dir, f"{name}.npy"),
                    np.asarray(losses, dtype=np.float64))
