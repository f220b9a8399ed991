from dorado_tpu_torch.pipeline.basecaller import BasecallerPipeline, PipelineStats

__all__ = ["BasecallerPipeline", "PipelineStats"]
