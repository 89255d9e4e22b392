"""Checkpoints: ``torch.save`` files with keep-N pruning, best-metric
tracking, post-training parameter averaging, component transfer, and the
iterator position to resume from.

Counterpart of ``daspeech_tpu/train/checkpoint.py`` (a rebuild of
``fairseq/fairseq/checkpoint_utils.py`` and
``fairseq/scripts/average_checkpoints.py``), with ``torch.save`` in place of
orbax. A checkpoint of a :class:`~daspeech_torch.train.TrainState` holds the
model's ``state_dict`` (parameters and BatchNorm statistics), the guarded
Adam state (both moments and both counts), the step and ``extra`` (the
training loop's ``epoch`` and ``batch_idx``: the iterator position). A
:class:`~daspeech_torch.train.VocoderTrainState` is saved as its generator,
discriminators and both optimizers. Any other state (nested dicts of
tensors, numpy arrays and numbers) is saved under ``"tree"``.

Each file is written under a temporary name and committed with
``os.replace``: :meth:`CheckpointManager.all_steps` lists committed files
only. ``checkpoint_<step>.json`` beside it holds the step, the metric and
``extra``, written after the commit.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from daspeech_torch.parallel.partition import copy_full_, full
from daspeech_torch.train.train_state import AdamState, TrainState
from daspeech_torch.train.vocoder_train import VocoderTrainState


def _host(x):
    """A host copy of ``x`` (tensors on the CPU, numpy arrays as tensors)
    that a later in-place update of ``x`` does not change."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.to("cpu", copy=True) if x.is_cuda else x.clone()
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x))
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


def _optimizer_state(opt) -> Dict[str, Any]:
    return {"state_dict": _host(opt.state_dict()), "count": opt.count}


def host_state(state) -> Dict[str, Any]:
    """The saved form of a training state, as host copies. A ``--fsdp``
    state is gathered to full tensors first, the same file as an unsharded
    run's; the gather is collective (every rank calls this)."""
    if isinstance(state, TrainState):
        s = state.opt_state
        model = {k: full(v) for k, v in state.model.state_dict().items()}
        return {"model": _host(model),
                "opt_state": {"mu": _host([full(m) for m in s.mu]),
                              "nu": _host([full(v) for v in s.nu]),
                              "count": _host(s.count),
                              "sched_count": _host(s.sched_count)}}
    if isinstance(state, VocoderTrainState):
        return {"gen": _host(state.gen.state_dict()),
                "disc": {k: _host(m.state_dict())
                         for k, m in state.disc.items()},
                "gen_opt": _optimizer_state(state.gen_opt),
                "disc_opt": _optimizer_state(state.disc_opt)}
    return {"tree": _host(state)}


def load_state_(state, data: Dict[str, Any]):
    """Copy a restored checkpoint into ``state`` (a TrainState or a
    VocoderTrainState) in place, on the devices ``state`` lives on; returns
    ``state``. A ``--fsdp`` state takes each rank's slice of the full
    tensors."""
    if isinstance(state, TrainState):
        s, o = state.opt_state, data["opt_state"]
        if state.sharding is None:
            state.model.load_state_dict(data["model"])
        else:
            own = state.model.state_dict()
            if set(own) != set(data["model"]):
                raise KeyError(f"checkpoint keys differ: "
                               f"{sorted(set(own) ^ set(data['model']))[:8]}")
            for k, v in own.items():
                copy_full_(v, data["model"][k])
        for dst, src in zip(s.mu + s.nu, o["mu"] + o["nu"]):
            copy_full_(dst, src)
        state.opt_state = AdamState(
            s.mu, s.nu, o["count"].to(s.count.device),
            o["sched_count"].to(s.sched_count.device))
    elif isinstance(state, VocoderTrainState):
        state.gen.load_state_dict(data["gen"])
        for k, m in state.disc.items():
            m.load_state_dict(data["disc"][k])
        for opt, key in ((state.gen_opt, "gen_opt"),
                         (state.disc_opt, "disc_opt")):
            opt.load_state_dict(data[key]["state_dict"])
            opt.count = data[key]["count"]
    else:
        raise TypeError(f"cannot load a checkpoint into {type(state)}")
    state.step = int(data["step"])
    return state


class CheckpointManager:
    """save/load with keep-last-N and best-metric policies
    (``CheckpointConfig``, ``fairseq/fairseq/dataclass/configs.py:643-781``)."""

    def __init__(self, directory, keep_last: int = 5,
                 maximize_best: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.maximize_best = maximize_best
        self._thread: Optional[threading.Thread] = None
        self._error: List[BaseException] = []

    def _path(self, step: int) -> Path:
        return self.dir / f"checkpoint_{step}.pt"

    def save(self, state, step: int, extra: Optional[Dict[str, Any]] = None,
             metric: Optional[float] = None, blocking: bool = True) -> Path:
        """Save a checkpoint.

        The state is copied to the host before this returns. With
        ``blocking=False`` the file is then written by a background thread
        (the reference saves asynchronously through iopath,
        ``fairseq/fairseq_cli/train.py:76-84``); one save is in flight at a
        time, so a save first waits for the previous one. Use
        ``blocking=True`` (the default) for a save that must be on disk
        before the process exits."""
        self.wait_until_finished()
        data = {**host_state(state), "step": int(step),
                "extra": dict(extra or {}), "metric": metric}
        if blocking:
            self._write(data, step, metric)
        else:
            self._thread = threading.Thread(
                target=self._write_in_background, args=(data, step, metric),
                daemon=True)
            self._thread.start()
        return self._path(step)

    def _write_in_background(self, data, step, metric):
        try:
            self._write(data, step, metric)
        except BaseException as e:      # raised by wait_until_finished
            self._error.append(e)

    def _write(self, data, step: int, metric: Optional[float]):
        path = self._path(step)
        tmp = path.with_name(f"{path.name}.{os.getpid()}."
                             f"{threading.get_ident()}.tmp")
        torch.save(data, tmp)
        # the meta first: a committed .pt always has its .json beside it
        meta = {"step": step, "metric": metric, **data["extra"]}
        _write_json(self.dir / f"checkpoint_{step}.json", meta)
        os.replace(tmp, path)
        self._prune()
        self._update_best(step, metric)

    def wait_until_finished(self):
        """Block until the save in flight (if any) has committed; raise
        what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            err = self._error.pop()
            self._error.clear()
            raise err

    def _prune(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep_last)]:
            if self._best_step() == s:
                continue
            self._path(s).unlink(missing_ok=True)
            (self.dir / f"checkpoint_{s}.json").unlink(missing_ok=True)

    def _update_best(self, step: int, metric: Optional[float]):
        if metric is None:
            return
        best_file = self.dir / "best.json"
        best = (json.loads(best_file.read_text())
                if best_file.exists() else None)
        better = (best is None or
                  (metric > best["metric"] if self.maximize_best
                   else metric < best["metric"]))
        if better:
            _write_json(best_file, {"step": step, "metric": metric})

    def _best_step(self) -> Optional[int]:
        best_file = self.dir / "best.json"
        if best_file.exists():
            return json.loads(best_file.read_text())["step"]
        return None

    def all_steps(self) -> List[int]:
        """The committed checkpoints' steps: a file being written has a
        ``.tmp`` name and is not listed."""
        out = []
        for p in self.dir.glob("checkpoint_*.pt"):
            suffix = p.stem.split("_", 1)[1]
            if suffix.isdigit():
                out.append(int(suffix))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def meta(self, step: int) -> Dict[str, Any]:
        """The step, metric and ``extra`` saved beside checkpoint ``step``."""
        return json.loads(
            (self.dir / f"checkpoint_{step}.json").read_text())

    def restore(self, state=None, step: Optional[int] = None):
        """The checkpoint of ``step`` (default: the latest), or None if
        there is none. Given a TrainState or VocoderTrainState, it is
        loaded into that state, which is returned; else the saved dict
        (tensors on the CPU) is: its ``"tree"`` for a saved tree."""
        self.wait_until_finished()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        data = torch.load(self._path(step), map_location="cpu",
                          weights_only=True)
        if state is not None:
            return load_state_(state, data)
        return data["tree"] if "tree" in data else data


def _write_json(path: Path, obj) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps(obj))
    os.replace(tmp, path)


def resume_position(manager: CheckpointManager,
                    step: Optional[int] = None):
    """(epoch, batch index) to resume from, saved in checkpoint ``step``'s
    ``extra`` (default: the latest); (0, 0) without a checkpoint."""
    step = step if step is not None else manager.latest_step()
    if step is None:
        return 0, 0
    meta = manager.meta(step)
    return int(meta.get("epoch", 0)), int(meta.get("batch_idx", 0))


def average_checkpoints(manager: CheckpointManager, last_n: int = 5,
                        keys: Optional[Sequence[str]] = None
                        ) -> Dict[str, torch.Tensor]:
    """Average the last-N checkpoints' model tensors
    (``fairseq/scripts/average_checkpoints.py:17-98``): a float64 sum in
    step order, divided by N, then float32. ``keys`` restricts the average
    to those names of the saved ``state_dict`` (the JAX package averages
    parameters only: pass the model's parameter names)."""
    steps = manager.all_steps()[-last_n:]
    if not steps:
        raise ValueError("no checkpoints to average")
    acc: Dict[str, torch.Tensor] = {}
    for s in steps:
        tree = manager.restore(step=s)["model"]
        for k in (keys if keys is not None else tree):
            x = tree[k].to(torch.float64)
            acc[k] = x if k not in acc else acc[k] + x
    n = len(steps)
    return {k: (a / n).to(torch.float32) for k, a in acc.items()}


def _with_prefix(params: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    return {k: v for k, v in params.items() if k.startswith(prefix)}


def _replace_prefix(target: Dict[str, Any], source: Dict[str, Any],
                    prefix: str) -> Dict[str, Any]:
    out = {k: v for k, v in target.items() if not k.startswith(prefix)}
    out.update(_with_prefix(source, prefix))
    return out


def load_pretrained_component(target_params: Dict, source_params: Dict,
                              component: str) -> Dict:
    """Copy a component (e.g. 'encoder', 'tts') from a source parameter
    dict into the target (``checkpoint_utils.load_pretrained_component_
    from_model``). Parameter dicts map dotted names to tensors, as
    ``dict(model.named_parameters())``."""
    prefix = f"{component}."
    if not _with_prefix(source_params, prefix):
        raise KeyError(f"{component!r} not in source checkpoint")
    return _replace_prefix(target_params, source_params, prefix)


def transfer_dag_params(target_params: Dict, source_params: Dict,
                        reset_vocab: bool = False) -> Dict:
    """Load a pretrained DA-Transformer into an S2S (or fresh S2T) model
    (``--load-pretrained-dag-from``, ``s2s_conformer_dag_fastspeech2.py:66-70``):
    the source's ``encoder``, ``enc_proj`` and ``decoder`` replace the
    target's (under ``dag.`` for an S2S target; an S2S source is read under
    its ``dag.``).

    With ``reset_vocab`` the decoder token embedding (and, when untied, the
    output projection) keep the target model's fresh values — the two-stage
    multilingual pretraining's vocabulary swap
    (``s2t_conformer_dag.py:94-99``, ``README.md:325-331``). Parameters
    only, as in the JAX package: BatchNorm statistics stay the target's.
    """
    src = dict(source_params)
    if any(k.startswith("dag.") for k in src):       # an S2S source
        src = {k[4:]: v for k, v in src.items() if k.startswith("dag.")}
    sub = "dag." if any(k.startswith("dag.") for k in target_params) else ""
    tgt_sub = {k[len(sub):]: v for k, v in target_params.items()
               if k.startswith(sub)}
    if reset_vocab and _with_prefix(src, "decoder.") \
            and _with_prefix(tgt_sub, "decoder."):
        for name in ("embed_tokens", "output_projection"):
            prefix = f"decoder.{name}."
            if _with_prefix(src, prefix) and _with_prefix(tgt_sub, prefix):
                src = _replace_prefix(src, tgt_sub, prefix)
    new_sub = tgt_sub
    for key in ("encoder", "enc_proj", "decoder"):
        if _with_prefix(src, f"{key}."):
            new_sub = _replace_prefix(new_sub, src, f"{key}.")
    if not sub:
        return new_sub
    out = {k: v for k, v in target_params.items() if not k.startswith(sub)}
    out.update({sub + k: v for k, v in new_sub.items()})
    return out


def transfer_tts_params(target_params: Dict, source_params: Dict) -> Dict:
    """Load pretrained FastSpeech2 parameters into the S2S model's ``tts``
    (``--load-pretrained-fastspeech-from``,
    ``s2s_conformer_dag_fastspeech2.py:79-83``). ``source_params`` are those
    of a standalone FastSpeech2Encoder; ``embed_tokens`` (absent in the
    NoEmb consumer) is dropped."""
    out = {k: v for k, v in target_params.items() if not k.startswith("tts.")}
    out.update({f"tts.{k}": v for k, v in source_params.items()
                if not k.startswith("embed_tokens.")})
    return out
