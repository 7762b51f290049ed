"""The yardsticks: the card's peaks, the rule that ties device kernels to the
port's operations, and the operations and bytes of the work a cell's inputs
need. A later benchmark change corrects them here."""
