"""The benchmark's plain references: numpy over the plaintext
measurements, independent of the program under test."""
