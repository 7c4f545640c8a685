"""Host-side IO: checkpoint (.bin) and tokenizer (.tokenizer) binary formats."""
