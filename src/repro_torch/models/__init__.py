"""Model families of the port (dense LM so far)."""
