"""Model families of the port (the reference FNN)."""
