from repro_torch.models.transformer import (build_window_array, cache_axes,
                                            cache_keys, decode_multi,
                                            decode_step, forward, init_cache,
                                            init_params, layer_template,
                                            model_template, param_axes,
                                            params_from_jax, prefill,
                                            supports_fused_decode)

__all__ = ["init_params", "params_from_jax", "forward", "prefill",
           "decode_step", "decode_multi", "supports_fused_decode",
           "init_cache", "build_window_array", "cache_keys", "cache_axes",
           "param_axes", "layer_template", "model_template"]
