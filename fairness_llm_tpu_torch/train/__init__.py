"""Training (counterpart of ``fairness_llm_tpu/train/``): the next-token
step with AdamW, remat, dp and the sequence-parallel ring, the loop, and
verified train-state checkpoints."""

from fairness_llm_tpu_torch.train.step import TrainState, make_train_step, train_loop

__all__ = ["TrainState", "make_train_step", "train_loop"]
