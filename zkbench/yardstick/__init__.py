"""The yardstick: the work the proofs need and the peaks of the chip."""
