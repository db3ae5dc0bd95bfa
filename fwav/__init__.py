"""fwav — a JAX rebuild of the FWAV fractal audio codec.

Public API mirrors the reference module surface (fractal.py): WAV I/O,
compress_audio / decompress_audio, the .fwav container, metrics, embeddings
and the search/solve ops — rebuilt as fused JAX/XLA programs for an
accelerator (an NVIDIA GPU; the CPU backend runs the same programs).
"""

from .config import EMBED_K, FWAV_VERSION, TOP_K, DecoderConfig, EncoderConfig, VADConfig
from .io import (
    MATCH_DTYPE,
    load_compressed,
    load_compressed_arrays,
    load_compressed_multi,
    read_wav,
    read_wav_mono,
    save_compressed,
    save_compressed_multi,
    write_wav,
)
from .models import (
    compress_audio,
    compress_audio_arrays,
    compress_audio_packed,
    decompress_audio,
    decompress_segment,
    process_file_compress,
    process_file_decompress,
)
from .models.stream import compress_audio_streaming
from .ops import (
    multi_head_embedding,
    tile_embedding,
    tonal_embedding,
    transient_embedding,
    voiced_detection,
)
from .utils import compute_snr

__version__ = "0.1.0"

__all__ = [
    "EMBED_K", "FWAV_VERSION", "TOP_K",
    "DecoderConfig", "EncoderConfig", "VADConfig",
    "MATCH_DTYPE", "load_compressed", "load_compressed_arrays",
    "load_compressed_multi", "save_compressed_multi",
    "read_wav", "read_wav_mono", "save_compressed", "write_wav",
    "compress_audio", "compress_audio_arrays", "compress_audio_packed",
    "compress_audio_streaming",
    "decompress_audio", "decompress_segment",
    "process_file_compress", "process_file_decompress",
    "multi_head_embedding", "tile_embedding", "tonal_embedding",
    "transient_embedding", "voiced_detection",
    "compute_snr",
]
