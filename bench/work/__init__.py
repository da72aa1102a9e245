"""The yardstick's arithmetic, frozen: the work a step or a prompt needs,
the card's peaks, and each sparse kernel's least time.  Later changes to the
program do not move it.  Imports nothing of the program."""
