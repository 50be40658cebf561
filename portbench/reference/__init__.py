"""The plain reference: both MMTM families in float32 PyTorch, the guided
controller and SGD, and the train flips' key stream.  It imports torch and
numpy only: nothing of the program, of JAX or of the JAX package."""
