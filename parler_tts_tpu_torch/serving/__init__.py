from parler_tts_tpu_torch.serving.batcher import BatchingEngine

__all__ = ["BatchingEngine"]
