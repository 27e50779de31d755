"""The yardstick's arithmetic: the card's published peaks, the bytes and
operations of the program's hand-written kernels counted from their input
shapes and data, and each configuration's forward FLOPs counted on the
frozen reference model."""
