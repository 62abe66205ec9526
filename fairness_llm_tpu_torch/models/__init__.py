"""Model configurations, tokenizer and transformer."""
