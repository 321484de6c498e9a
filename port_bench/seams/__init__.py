"""One module per seam of the program that a cell drives."""
