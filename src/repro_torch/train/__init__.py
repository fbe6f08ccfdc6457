"""Training utilities of the port; ``checkpoint`` so far (the LM training
loop, optimizer and losses are ROADMAP.md Queue 1 item 14c)."""
