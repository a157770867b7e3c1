"""CPU tests of the benchmark; the card-marked ones run on the chip."""
