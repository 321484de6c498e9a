"""The benchmark's input generators; they import nothing of the program
under test."""
