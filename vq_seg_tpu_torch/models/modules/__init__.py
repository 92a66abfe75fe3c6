"""Building blocks shared by the networks: vector quantizer and decoder."""
