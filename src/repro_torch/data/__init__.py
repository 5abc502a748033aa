from repro_torch.data.synthetic import (binary_strokes, image_batches,
                                        quantized_textures, synthetic_tokens,
                                        token_batches)

__all__ = ["binary_strokes", "quantized_textures", "synthetic_tokens",
           "image_batches", "token_batches"]
