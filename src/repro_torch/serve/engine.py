"""Wave-batched LM serving engine over the transformer KV-cache API: the
port's copy of ``repro.serve.engine``.

The engine owns a fixed (num_slots, max_len) KV cache; up to
``num_slots`` requests are admitted per WAVE, prefilled token-by-token
through the same ``serve_step`` used for decode, and the wave retires
when every member finishes (EOS / token budget / cache end).
Early-finishing slots idle masked: all lanes step together, finished
lanes burn no semantics. The outer queue -> wave -> finished loop is the
shared ``serve/waves.WaveScheduler``.

Where the reference jits ``serve_step`` once, the port calls it eagerly
under ``torch.inference_mode()`` on the device its parameters live on;
the per-token host sync stays, as the ``argmax(...).cpu()`` that feeds
the next token back.

Capacity contract (validated at ``submit``, never silently violated by
the wave loop): a prompt of P tokens occupies cache rows 0..P-1 during
prefill, the first output token is predicted off row P-1, and each
further token must be fed back through a fresh row -- so P <= max_len
is required to emit anything at all, and the most a request can ever
get is ``max_len - P + 1`` tokens (the run that writes the final cache
row). Overlong prompts either raise (``on_overflow="error"``) or keep
their last ``max_len`` tokens with ``req.truncated`` set
(``on_overflow="truncate"``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.components import check_choice
from repro_torch.models.transformer import init_kv_cache, serve_step
from repro_torch.obs import trace
from repro_torch.serve.waves import WaveScheduler

OVERFLOW_POLICIES = ("error", "truncate")


@dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int = 16
    eos_id: int | None = None
    output: list[int] = field(default_factory=list)
    done: bool = False
    truncated: bool = False  # prompt clipped by on_overflow="truncate"
    failed: bool = False  # quarantined by the containment layer
    error: str | None = None  # captured failure, when failed


class ServeEngine(WaveScheduler):
    def __init__(
        self,
        params,
        cfg,
        *,
        num_slots: int = 4,
        max_len: int = 256,
        on_overflow: str = "error",
        max_retries: int = 1,
        on_failure: str = "quarantine",
        fault_plan=None,
    ):
        check_choice("on_overflow", on_overflow, OVERFLOW_POLICIES)
        super().__init__(
            max_retries=max_retries, on_failure=on_failure,
            fault_plan=fault_plan,
        )
        self.params = params
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = max_len
        self.on_overflow = on_overflow
        self.device = params.embed.device

    def submit(self, req: Request):
        """Admit a request, enforcing the cache-capacity contract.

        ``max_new_tokens <= 0`` requests finish immediately (empty
        output) instead of burning a wave slot; prompts longer than
        ``max_len`` could never emit a token, so they raise (or are
        truncated to their last ``max_len`` tokens under
        ``on_overflow="truncate"``) rather than exhausting the wave
        loop with ``done=False`` -- the silent-drop failure mode.
        """
        if not req.prompt:
            raise ValueError(f"request {req.uid}: empty prompt")
        if req.max_new_tokens <= 0:
            self._register(req)  # delivered by the next run(); uid in flight
            req.done = True
            self.finished.append(req)
            return
        if len(req.prompt) > self.max_len:
            if self.on_overflow == "error":
                raise ValueError(
                    f"request {req.uid}: prompt length {len(req.prompt)} "
                    f"exceeds max_len={self.max_len} (no room to emit a "
                    "token); shorten it or use on_overflow='truncate'"
                )
            req.prompt = list(req.prompt[-self.max_len:])
            req.truncated = True
        super().submit(req)

    # ------------------------------------------------------------------
    def _next_wave(self) -> list[Request]:
        wave = self.queue[: self.num_slots]
        self.queue = self.queue[self.num_slots:]
        return wave

    def _degrade(self, wave: list[Request], exc: Exception) -> list | None:
        """OOM-shaped failure: permanently halve the KV-cache width
        (the (num_slots, max_len) allocation) and re-pack this wave
        into narrower sub-waves. At one slot there is nothing left to
        shrink, so the request quarantines."""
        if self.num_slots <= 1 or len(wave) <= 1:
            return None
        self.num_slots = max(1, self.num_slots // 2)
        k = self.num_slots
        return [wave[i:i + k] for i in range(0, len(wave), k)]

    @torch.inference_mode()
    def _run_wave(self, wave: list[Request]):
        if self.fault_plan is not None:
            self.fault_plan.check_wave(wave)
            self.fault_plan.check_slots(self.num_slots)
        cache = init_kv_cache(self.cfg, self.num_slots, self.max_len,
                              device=self.device)
        pending = [list(r.prompt) for r in wave]
        active = [True] * len(wave)
        pos = 0
        # One span per wave, not per token: the lockstep loop already
        # syncs every step (the argmax read), so a span per token would
        # add trace events, not information.
        with trace.span(
            "serve.wave.decode", requests=len(wave), slots=self.num_slots,
        ) as sp:
            while any(active) and pos < self.max_len:
                tokens = np.zeros((self.num_slots, 1), np.int64)
                for s, r in enumerate(wave):
                    if pending[s]:
                        tokens[s, 0] = pending[s][0]
                    elif r.output:
                        tokens[s, 0] = r.output[-1]
                    else:
                        tokens[s, 0] = r.prompt[-1]
                logits, cache = serve_step(
                    self.params, self.cfg, cache, torch.from_numpy(tokens), pos
                )
                nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
                for s, r in enumerate(wave):
                    if not active[s]:
                        continue
                    if pending[s]:
                        pending[s].pop(0)
                        if pending[s]:
                            continue  # still prefilling; prediction unused
                    tok = int(nxt[s])
                    r.output.append(tok)
                    if (
                        len(r.output) >= r.max_new_tokens
                        or (r.eos_id is not None and tok == r.eos_id)
                        # continuing needs row pos + 1 for the fed-back
                        # token: retire only once that row would fall off
                        # the cache, so the final row is usable like any
                        # other.
                        or pos + 2 > self.max_len
                    ):
                        r.done = True
                        active[s] = False
                pos += 1
            sp.tag(steps=pos)
        self.metrics.inc("serve.lm.waves")
        self.metrics.inc("serve.lm.steps", pos)
        self.metrics.inc(
            "serve.lm.tokens", sum(len(r.output) for r in wave)
        )

    def run(self) -> list[Request]:
        """Process the whole queue; returns the requests that reached a
        terminal state during THIS call (``done``, or ``failed`` under
        injected/real faults) in completion order -- zero-budget
        requests finish at submit and deliver with the next run."""
        return super().run()
