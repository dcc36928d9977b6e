"""A copy of the benchmark at tiny widths, for tests on the CPU.

`tiny_root(dir)` copies BENCHMARK.json and stretto_bench/ into `dir` and
shrinks every configuration (and the port's view of it) and every cell's
traffic, keeping the kinds and the metrics. A gap's size depends on the
widths and the depth, so the tiny cells get limits of their own, set by
the cells' rule between this size's readings (seed 2**31 + 99 and two
others, CPU): sound runs 0.005-0.006 (logits) and 0.013-0.016 (answers)
in the flush cells, 0.016 / 0.007 / 0.013 (logits, cache, scores) in the
prefill cell; the float8 control 0.059-0.076, 0.10-0.19, and 0.125-0.149
/ 0.067-0.080 / 0.13-0.15."""
import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

GQA = {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
       "num_key_value_heads": 2, "head_dim": 16, "num_hidden_layers": 2,
       "vocab_size": 256}
GQA_PORT = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
            "d_head": 16, "d_ff": 128, "vocab_size": 256}
MLA = {"hidden_size": 64, "num_attention_heads": 4, "kv_lora_rank": 16,
       "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
       "n_routed_experts": 8, "num_experts_per_tok": 2,
       "moe_intermediate_size": 32, "n_shared_experts": 1,
       "num_hidden_layers": 2, "vocab_size": 256}
MLA_PORT = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
            "d_head": 16, "d_ff": 32, "vocab_size": 256,
            "mla": {"kv_lora_rank": 16, "qk_nope_dim": 16,
                    "qk_rope_dim": 8, "v_head_dim": 16},
            "moe": {"n_experts": 8, "top_k": 2, "d_ff_expert": 32,
                    "n_shared_experts": 1}}
FLUSH = {"batch": 8, "len_min": 40, "len_max": 160, "sample_from": 3,
         "sample_flushes": 2, "warm_flushes": 1}
PREFILL = {"n_docs": 4, "len_min": 40, "len_max": 200}
LIMITS = {"gold_flush": {"logits_err": 0.02, "answer_err": 0.05},
          "prefill": {"logits_err": 0.05, "cache_err": 0.025,
                      "score_err": 0.04}}


def shrink_config(model: dict) -> dict:
    model = dict(model)
    tiny, port = (MLA, MLA_PORT) if "kv_lora_rank" in model \
        else (GQA, GQA_PORT)
    model.update(tiny)
    model["port"] = dict(model["port"], replace=port)
    return model


def tiny_root(dest) -> Path:
    dest = Path(dest)
    shutil.copytree(ROOT / "stretto_bench", dest / "stretto_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    for conf in bench["configs"]:
        path = dest / conf["file"]
        path.write_text(json.dumps(shrink_config(json.loads(
            path.read_text()))))
    for cell in bench["workloads"]:
        path = dest / "stretto_bench" / "workloads" / f"{cell['name']}.json"
        w = json.loads(path.read_text())
        w["params"].update(FLUSH if w["kind"] == "gold_flush" else PREFILL)
        w["limits"] = LIMITS[w["kind"]]
        path.write_text(json.dumps(w))
    return dest
