"""Dense GQA transformer (the qwen family) on torch tensors."""
