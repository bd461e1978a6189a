"""The data pipeline of the port (numpy, as ``repro.data``)."""
from .pipeline import (DataConfig, byte_tokenize, make_dataset, prefetch,
                       synthetic_token_stream)

__all__ = ["DataConfig", "byte_tokenize", "make_dataset", "prefetch",
           "synthetic_token_stream"]
