"""QA evaluation harness: the port's copy of quickvideo_tpu/evaluation."""

from quickvideo_tpu_torch.evaluation.qa import (
    QASample,
    extract_choice,
    format_mc_question,
    run_qa_eval,
    shard_samples,
)
