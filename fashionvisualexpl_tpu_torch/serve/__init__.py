from fashionvisualexpl_tpu_torch.serve.engine import RecServer, quantize_rows

__all__ = ["RecServer", "quantize_rows"]
