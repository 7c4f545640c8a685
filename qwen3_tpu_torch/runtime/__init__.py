"""Runtime: sampling, generation loops, engine assembly, chat sessions."""
