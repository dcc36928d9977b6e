"""Physical operator implementations against the serving engine.

The port of `repro.serving.operators`, unchanged apart from its imports
and the embedding filter, which reads the engine's host copy of the
embedding table (copied once per model) instead of copying it per call.

The registry produced by `make_registry` is what the planner/profiler
consume: for every semantic operator it returns the cascade candidates in
cost order, gold last:

  filters: [embedding filter, sm @ high-comp ... lg @ comp ..., lg @ 0 = gold]
  maps:    [python extractor, sm ladder ..., lg ladder ..., lg @ 0 = gold]
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Sequence, Tuple

import numpy as np

from repro_torch.core.logical import SemFilter, SemJoin, SemMap
from repro_torch.core.physical import PhysicalOperator
from repro_torch.data.synthetic import (N_VALUES, TOK_NO, TOK_YES, Item,
                                        filter_query_token,
                                        filter_signal_token, map_query_token,
                                        map_signal_token, value_token)
from repro_torch.serving.engine import ServingEngine


class KVCacheLLMOperator(PhysicalOperator):
    """The paper's contribution: LLM operator over a precomputed
    (compressed) KV-cache profile — prefill skipped."""

    uses_llm = True

    def __init__(self, engine: ServingEngine, model_name: str, ratio: float,
                 is_gold: bool = False, quant: bool = False):
        self.engine = engine
        self.model_name = model_name
        self.ratio = ratio
        self.is_gold = is_gold
        self.quant = quant
        self.name = (f"{model_name}-kv{int(round(ratio * 100)):02d}"
                     + ("i8" if quant else ""))

    def run_filter(self, items: Sequence[Item], op: SemFilter) -> np.ndarray:
        ids = [it.item_id for it in items]
        return self.engine.run_filter(
            self.model_name, self.ratio, ids,
            [filter_query_token(op.task_id)], TOK_YES, TOK_NO,
            quant=self.quant)

    def run_map(self, items: Sequence[Item], op: SemMap):
        ids = [it.item_id for it in items]
        vals, conf = self.engine.run_map(
            self.model_name, self.ratio, ids, [map_query_token(op.task_id)],
            [value_token(v) for v in range(N_VALUES)], quant=self.quant)
        return vals, conf

    def cost_model(self) -> float:
        d = self.engine.models[self.model_name].cfg.d_model
        cost = d ** 2 * (1.0 - 0.6 * self.ratio)
        if self.quant:
            # int8 KV streams ~half the HBM bytes of the bf16/f32 cache;
            # the planner prices the memory-bound decode accordingly
            cost *= 0.55
        return cost

    def max_batch(self):
        """Memory-budgeted batch cap for this profile: the compression ->
        batch-size link the batch-aware cost model feeds to the planner."""
        return self.engine.max_batch_for(self.model_name, self.ratio,
                                         quant=self.quant)


class EmbeddingFilterOperator(PhysicalOperator):
    """BLIP-style embedding similarity filter: cosine between the item's
    mean token embedding and the task's signal direction. No LLM call."""

    uses_llm = False
    is_gold = False

    def __init__(self, engine: ServingEngine, model_name: str):
        self.engine = engine
        self.model_name = model_name
        self.name = f"emb-{model_name}"

    def run_filter(self, items: Sequence[Item], op: SemFilter) -> np.ndarray:
        E = self.engine.host_embed(self.model_name)
        # probe direction: mean difference of the task's yes/no signal
        # token embeddings (a calibrated contrastive probe)
        yes = np.mean([E[filter_signal_token(op.task_id, 1, i)]
                       for i in range(4)], axis=0)
        no = np.mean([E[filter_signal_token(op.task_id, 0, i)]
                      for i in range(4)], axis=0)
        probe = yes - no
        probe /= np.linalg.norm(probe) + 1e-9
        out = np.zeros(len(items), np.float32)
        for i, it in enumerate(items):
            v = E[np.asarray(it.tokens)].mean(0)
            out[i] = 8.0 * float(v @ probe / (np.linalg.norm(v) + 1e-9))
        return out

    def cost_model(self) -> float:
        return 1.0


class PythonMapOperator(PhysicalOperator):
    """Generated-code extractor: counts value-token occurrences. Only knows
    the corpus conventions partially (it cannot see attention-composed
    evidence), so it is decisive on easy items and unsure otherwise."""

    uses_llm = False
    is_gold = False

    def __init__(self):
        self.name = "python-map"

    def run_filter(self, items, op):
        raise NotImplementedError

    def run_map(self, items: Sequence[Item], op: SemMap):
        vals = np.zeros(len(items), np.int64)
        conf = np.zeros(len(items), np.float32)
        for i, it in enumerate(items):
            counts = np.zeros(N_VALUES)
            for t in it.tokens:
                for v in range(N_VALUES):
                    if t == map_signal_token(op.task_id, v):
                        counts[v] += 1
            order = np.argsort(counts)[::-1]
            vals[i] = value_token(int(order[0]))
            conf[i] = float(counts[order[0]] - counts[order[1]])
        return vals, conf

    def cost_model(self) -> float:
        return 0.5


class KVCachePairOperator(PhysicalOperator):
    """Pair-scoring operator for SemJoin: runs the join's extraction task
    over both sides' precomputed KV-cache profiles and scores agreement —
    positive log-odds when both sides express the same latent value, with
    magnitude the mean extraction confidence. Two engine calls per batch
    (left ids, right ids); KV-bytes telemetry counts both sides' cache
    loads, exactly what the pair cascade really streams."""

    uses_llm = True

    def __init__(self, engine: ServingEngine, model_name: str, ratio: float,
                 is_gold: bool = False, quant: bool = False):
        self.engine = engine
        self.model_name = model_name
        self.ratio = ratio
        self.is_gold = is_gold
        self.quant = quant
        self.name = (f"{model_name}-pair{int(round(ratio * 100)):02d}"
                     + ("i8" if quant else ""))

    def _side(self, ids: Sequence[int], op: SemJoin):
        return self.engine.run_map(
            self.model_name, self.ratio, ids, [map_query_token(op.task_id)],
            [value_token(v) for v in range(N_VALUES)], quant=self.quant)

    def run_filter(self, pairs: Sequence[Any], op: SemJoin) -> np.ndarray:
        vl, cl = self._side([p.left.item_id for p in pairs], op)
        vr, cr = self._side([p.right.item_id for p in pairs], op)
        # agreement log-odds: sign from value match, magnitude from the
        # mean margin (floored so the gold boundary at 0 stays two-sided)
        margin = np.maximum(0.5 * (np.asarray(cl, np.float32)
                                   + np.asarray(cr, np.float32)), 1e-3)
        return np.where(np.asarray(vl) == np.asarray(vr),
                        margin, -margin).astype(np.float32)

    def cost_model(self) -> float:
        d = self.engine.models[self.model_name].cfg.d_model
        cost = 2.0 * d ** 2 * (1.0 - 0.6 * self.ratio)   # two side calls
        if self.quant:
            cost *= 0.55
        return cost

    def max_batch(self):
        return self.engine.max_batch_for(self.model_name, self.ratio,
                                         quant=self.quant)


class PythonPairOperator(PhysicalOperator):
    """Generated-code pair matcher: the PythonMapOperator heuristic run on
    both sides, agreement of the top value-token counts. Decisive only on
    easy pairs — the cheap front of the pairing cascade."""

    uses_llm = False
    is_gold = False

    def __init__(self):
        self.name = "python-pair"

    @staticmethod
    def _top(tokens, task_id: int) -> Tuple[int, float]:
        counts = np.zeros(N_VALUES)
        for t in tokens:
            for v in range(N_VALUES):
                if t == map_signal_token(task_id, v):
                    counts[v] += 1
        order = np.argsort(counts)[::-1]
        return int(order[0]), float(counts[order[0]] - counts[order[1]])

    def run_filter(self, pairs: Sequence[Any], op: SemJoin) -> np.ndarray:
        out = np.zeros(len(pairs), np.float32)
        for i, p in enumerate(pairs):
            vl, ml = self._top(p.left.tokens, op.task_id)
            vr, mr = self._top(p.right.tokens, op.task_id)
            margin = 0.5 * (ml + mr)
            out[i] = margin if vl == vr else -margin
        return out

    def cost_model(self) -> float:
        return 1.0


def make_registry(engine: ServingEngine, *, sm: str = "sm", lg: str = "lg",
                  sm_ratios=(0.8, 0.5, 0.0), lg_ratios=(0.8, 0.5, 0.3),
                  sm_int8=(), lg_int8=(),
                  include_cheap: bool = True):
    """Build the semantic-op -> cascade-candidates registry (gold last).

    `sm_int8` / `lg_int8` list compression ratios whose int8-quantized
    profiles exist in the store; each becomes a distinct cascade
    candidate (suffix `i8`) the planner prices at the halved HBM traffic.
    """

    def registry(op) -> List[PhysicalOperator]:
        if isinstance(op, SemJoin):
            pair_ops: List[PhysicalOperator] = []
            if include_cheap:
                pair_ops.append(PythonPairOperator())
            for r in sm_ratios:
                pair_ops.append(KVCachePairOperator(engine, sm, r))
            for r in lg_ratios:
                pair_ops.append(KVCachePairOperator(engine, lg, r))
            pair_ops.append(KVCachePairOperator(engine, lg, 0.0,
                                                is_gold=True))
            return pair_ops
        ops: List[PhysicalOperator] = []
        if isinstance(op, SemFilter):
            if include_cheap:
                ops.append(EmbeddingFilterOperator(engine, sm))
        else:
            if include_cheap:
                ops.append(PythonMapOperator())
        for r in sm_int8:
            ops.append(KVCacheLLMOperator(engine, sm, r, quant=True))
        for r in sm_ratios:
            ops.append(KVCacheLLMOperator(engine, sm, r))
        for r in lg_int8:
            ops.append(KVCacheLLMOperator(engine, lg, r, quant=True))
        for r in lg_ratios:
            ops.append(KVCacheLLMOperator(engine, lg, r))
        ops.append(KVCacheLLMOperator(engine, lg, 0.0, is_gold=True))
        return ops

    return registry
